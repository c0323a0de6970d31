"""The port's dry-run (``repro_torch.launch.dryrun``) on small fake meshes.
The fake process group is global to a process, so each test runs its
traces in a subprocess: the report's keys are the reference report's, the
argument bytes are the local shards' bytes, the depth probe's
extrapolation equals a full-depth trace exactly, a row-parallel ``w_down``
costs one reduction of the residual stream, and the perf variants' spec
overrides give the reference's specs."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent

# DTensor's sharding propagation before torch 2.13 refuses a step that 2.13
# traces (torch 2.11 refuses this one, and the dry-run then writes the
# configuration's report as ok: false with DTensor's error).
_TORCH = tuple(int(x) for x in torch.__version__.split("+")[0].split(".")[:2])
_NO_ROLL = pytest.mark.skipif(
    _TORCH < (2, 13), reason="DTensor before torch 2.13 has no sharding "
    "strategy for aten.roll (a prompt longer than Hymba's ring places its "
    "K/V with layers.ring_kv)")

_PRELUDE = """
import json, torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.shapes import ShapeSpec
torch.set_num_threads(1)
def fake_mesh(shape, names=("data", "model")):
    n = 1
    for s in shape:
        n *= s
    dryrun.start_fake_world(n)
    return init_device_mesh("cuda", shape, mesh_dim_names=names)
def tally_dict(t):
    return {"flops": t.flops, "bytes": t.bytes, "out_bytes": t.out_bytes,
            "peak": t.peak, "view_copies": t.view_copies, "coll": t.records()}
"""


def _run(body: str, timeout=240):
    code = _PRELUDE + textwrap.dedent(body)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-4000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("JSON")][-1]
    return json.loads(line[4:])


def _keys(d):
    return {k: sorted(v) if isinstance(v, dict) else None for k, v in d.items()}


def _reference_report_keys():
    """``_keys`` of the reference's dry-run report, from the reference's own
    code: ``run_one``'s report (``src/repro/launch/dryrun.py:61-77``), its
    ``memory_analysis`` and ``cost_analysis`` keys as written there, and
    the keys of ``roofline.build(...).to_dict()`` and of
    ``roofline.collective_bytes`` (its ``_counts`` the collective counts).
    ``repro.launch.dryrun`` itself is not imported: it sets ``XLA_FLAGS``
    to 512 host devices at import."""
    pytest.importorskip("jax")
    from repro.launch import roofline as jrl

    coll = jrl.collective_bytes("")
    roof = jrl.build("xlstm-125m", "decode_32k", "pod16x16", 256, {}, {})
    keys = dict.fromkeys(("arch", "shape", "mesh", "chips", "ok", "lower_s",
                          "compile_s"))
    keys.update({
        "memory_analysis": sorted((
            "generated_code_size_in_bytes", "argument_size_in_bytes",
            "output_size_in_bytes", "temp_size_in_bytes",
            "alias_size_in_bytes")),
        "cost_analysis": sorted(("flops", "bytes accessed", "transcendentals")),
        "collective_bytes": sorted(k for k in coll if k != "_counts"),
        "collective_counts": sorted(coll["_counts"]),
        "roofline": sorted(roof.to_dict()),
    })
    return keys


def test_report_keys_and_argument_bytes():
    """A reduced gemma-2b train step on a (2, 4) fake mesh: the report has
    the keys of the reference's report (every nested dict too), and
    ``argument_size_in_bytes`` is the sum of the local shards' bytes,
    worked out from the specs alone."""
    out = _run("""
        from repro_torch import tree as tree_lib
        from repro_torch.sharding import specs as sh
        mesh = fake_mesh((2, 4))
        cfg = shapes._dryrun_cfg("gemma-2b").reduced()
        spec = ShapeSpec("train_tiny", "train", 32, 4)
        rep = dryrun.make_report("gemma-2b", spec, mesh, "test2x4", cfg,
                                 verbose=False)
        fn, args, _ = shapes.build_lowerable("gemma-2b", spec.name, cfg=cfg,
                                             shape=spec)
        sizes = {"data": 2, "model": 4}
        params, opt, batch = args
        ps = sh.param_specs(params, sizes, cfg)
        trees = [(params, ps), (opt["mu"], ps), (opt["nu"], ps),
                 (batch, sh.batch_specs(batch, sizes))]
        want = 4                                   # the step count, int32
        for t, s in trees:
            flat_t, flat_s = [], []
            def walk(a, b):
                if isinstance(a, dict):
                    for k in a: walk(a[k], b[k])
                else:
                    flat_t.append(a); flat_s.append(b)
            walk(t, s)
            for leaf, spec_ in zip(flat_t, flat_s):
                n = 1
                for d in sh.local_shape(leaf.shape, spec_, sizes):
                    n *= d
                want += n * leaf.element_size()
        print("JSON" + json.dumps({"report": rep, "want": want}))
    """)
    rep = out["report"]
    assert _keys(rep) == _reference_report_keys()
    assert rep["ok"] is True and rep["chips"] == 8
    assert rep["memory_analysis"]["argument_size_in_bytes"] == out["want"]
    assert rep["memory_analysis"]["output_size_in_bytes"] > 0
    assert rep["memory_analysis"]["temp_size_in_bytes"] > 0
    assert rep["cost_analysis"]["flops"] > 0
    assert rep["collective_counts"]["all-reduce"] > 0
    roof = rep["roofline"]
    assert roof["collective_s"] == roof["collective_bytes_per_device"] / 50e9
    assert roof["compute_s"] == roof["flops_per_device"] / 989e12


_MESH2 = ((2, 4), ("data", "model"))
_MESH3 = ((2, 2, 4), ("pod", "data", "model"))


@pytest.mark.parametrize("arch,shape_kind,full,mesh", [
    pytest.param("yi-9b", "train", {"n_layers": 8}, _MESH2,
                 id="yi-9b-train-full0"),
    pytest.param("olmoe-1b-7b", "train", {"n_layers": 8}, _MESH2,
                 id="olmoe-1b-7b-train-full1"),
    pytest.param("hymba-1.5b", "prefill", {"n_layers": 7}, _MESH2,
                 id="hymba-1.5b-prefill-full2"),
    pytest.param("seamless-m4t-medium", "prefill",
                 {"n_enc_layers": 7, "n_layers": 8}, _MESH2,
                 id="seamless-m4t-medium-prefill-full3"),
    pytest.param("xlstm-125m", "prefill", {"n_layers": 8}, _MESH2,
                 id="xlstm-125m-prefill-full4"),
    # the 3-D mesh of the multi-pod production mesh, and the xLSTM's
    # train step (4 heads: its recurrences' loops folded on meta, the
    # backward's too)
    pytest.param("gemma-2b", "train", {"n_layers": 8}, _MESH3,
                 id="gemma-2b-train-pod2x2x4"),
    pytest.param("hymba-1.5b", "train", {"n_layers": 8}, _MESH3,
                 id="hymba-1.5b-train-pod2x2x4"),
    pytest.param("xlstm-125m", "train", {"n_layers": 8}, _MESH2,
                 id="xlstm-125m-train-full5"),
])
def test_depth_probe_equals_full_trace(arch, shape_kind, full, mesh):
    """The probes' extrapolation equals the full-depth trace: FLOPs,
    output bytes and the collectives' counts and bytes per kind and mesh
    dim exactly; the bytes accessed and the peak of live bytes within 1%
    (DTensor's own local helpers in a redistribution, such as an
    ``arange`` or a ``cat``, do not scale with depth; nor does an xLSTM
    block's live set exactly, whose leaves are a list a block)."""
    shape, names = mesh
    out = _run(f"""
        mesh = fake_mesh({shape!r}, {names!r})
        cfg = shapes._dryrun_cfg({arch!r}).reduced().replace(**{full!r})
        spec = ShapeSpec("tiny", {shape_kind!r}, 32, 4)
        probe = dryrun.probe_step({arch!r}, spec, mesh, cfg)
        whole = dryrun.trace_step({arch!r}, spec, mesh, cfg)
        depths = [p.n_layers + p.n_enc_layers for _, p in
                  dryrun.depth_probes(cfg)]
        print("JSON" + json.dumps({{"probe": tally_dict(probe),
                                   "whole": tally_dict(whole),
                                   "depths": depths}}))
    """)
    probe, whole = out["probe"], out["whole"]
    for key in ("flops", "out_bytes", "view_copies", "coll"):
        assert probe[key] == whole[key], key
    assert probe["bytes"] == pytest.approx(whole["bytes"], rel=1e-2)
    assert probe["peak"] == pytest.approx(whole["peak"], rel=1e-2)
    assert whole["peak"] > 0
    assert whole["coll"]
    assert max(out["depths"]) < sum(full.values())


@pytest.mark.parametrize("shape_kind", ["train", "prefill"])
def test_folded_loop_equals_the_whole_loop(shape_kind):
    """A reduced xLSTM (an mLSTM and its first sLSTM, 4 heads) over 32
    steps on a (2, 4) fake mesh, its recurrences folded to two steps on
    meta (``shardwise.FoldedLoop``) and run step by step: the FLOPs within
    0.1 % (the first step starts from the initial state) and the peak of
    live bytes within 1 %. Under autograd every step's saved tensors stay
    alive to the backward, which the fold counts from its first step's
    survivors; the prefill keeps each step's output."""
    out = _run(f"""
        from repro_torch.sharding import shardwise
        mesh = fake_mesh((2, 4))
        cfg = shapes._dryrun_cfg("xlstm-125m").reduced()
        cfg = cfg.replace(n_layers=cfg.slstm_every)
        spec = ShapeSpec("tiny", {shape_kind!r}, 32, 4)
        res = {{}}
        for fold in (True, False):
            shardwise.FoldedLoop.FOLD = fold
            res[str(fold)] = tally_dict(dryrun.trace_step("xlstm-125m", spec,
                                                          mesh, cfg))
        print("JSON" + json.dumps(res))
    """)
    folded, whole = out["True"], out["False"]
    assert folded["flops"] == pytest.approx(whole["flops"], rel=1e-3)
    assert folded["peak"] == pytest.approx(whole["peak"], rel=1e-2)
    assert whole["peak"] > 0


@pytest.mark.parametrize("arch,S,T", [
    pytest.param("yi-9b", 32, None, id="dense-replaced"),
    pytest.param("yi-9b", 32, 64, id="dense-in-place"),
    pytest.param("hymba-1.5b", 96, None, marks=_NO_ROLL, id="hymba-ring"),
    pytest.param("hymba-1.5b", 32, None, id="hymba-in-place"),
])
def test_step_outputs_are_placed_like_the_cache(arch, S, T):
    """A prefill's outputs hold no partial sum, and its K/V cache comes
    back placed as it went in (``cache_specs``), both where the prompt
    replaces the cache's K/V (a dense decoder's prompt as long as its
    cache, Hymba's longer than its ring) and where it is written in place:
    the output bytes are the cache's shards by ``cache_specs`` and the
    logits' shard, not the global K/V of an unreduced partial sum.
    (Hymba's SSM states keep the shards the step gives them, of the same
    local size.)"""
    out = _run(f"""
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch import tree as tree_lib
        from repro_torch.models.api import build_model
        from repro_torch.sharding import specs as sh
        mesh = fake_mesh((2, 4))
        dims = {{mesh.get_group(i).group_name: n
                for i, n in enumerate(mesh.mesh_dim_names)}}
        def tensors(tree):
            return [x for x in tree_lib.leaves(tree) if isinstance(x, torch.Tensor)]
        res = {{}}
        for arch, S, T in (({arch!r}, {S!r}, {T!r}),):
            cfg = shapes._dryrun_cfg(arch).reduced()
            fn, (params, batch, cache), shardings = shapes.build_lowerable(
                arch, "tiny", cfg=cfg, shape=ShapeSpec("tiny", "prefill", S, 4))
            if T:
                cache = build_model(cfg).init_cache(4, T, device="meta")
            pp, bp, _ = shardings(mesh)
            specs = sh.cache_specs(cache, mesh)
            dcache = sh.distribute(cache, shapes._tree_placements(specs, mesh), mesh)
            dargs = (sh.distribute(params, pp, mesh), sh.distribute(batch, bp, mesh),
                     dcache)
            placed_in = [str(dcache[k].placements) for k in ("k", "v")]
            tally = dryrun.Tally()
            with dryrun._step_trace_mode(tally, dims), implicit_replication():
                logits, new = fn(*dargs)
            kv = {{k: cache[k] for k in ("k", "v")}}
            want = (dryrun.tree_local_bytes(logits)
                    + dryrun.tree_local_bytes(sh.distribute(
                        kv, shapes._tree_placements(
                            {{k: specs[k] for k in kv}}, mesh), mesh))
                    + dryrun.tree_local_bytes(new.get("ssm")))
            res[arch] = {{
                "in": placed_in, "out": [str(new[k].placements) for k in ("k", "v")],
                "partial": [str(x.placements) for x in tensors((logits, new))
                            if any(p.is_partial() for p in x.placements)],
                "out_bytes": dryrun.tree_local_bytes((logits, new)), "want": want}}
        print("JSON" + json.dumps(res))
    """)
    assert len(out) == 1
    for case, r in out.items():
        assert r["out"] == r["in"], case
        assert r["partial"] == [], case
        assert r["out_bytes"] == r["want"], case


def test_combine_refuses_negative_terms():
    """The depth extrapolation raises on any negative term: FLOPs, bytes,
    output bytes, a peak, collective counts or bytes."""
    from repro_torch.launch import dryrun

    def tally(**kw):
        t = dryrun.Tally()
        for k, v in kw.items():
            setattr(t, k, v)
        return t
    fine = dryrun.Tally().combine([(3, tally(out_bytes=10)),
                                   (-1, tally(out_bytes=30))])
    assert fine.out_bytes == 0
    for key in ("flops", "bytes", "out_bytes"):
        with pytest.raises(RuntimeError, match="negative"):
            dryrun.Tally().combine([(1, tally(**{key: 10})),
                                    (-1, tally(**{key: 30}))])
    with pytest.raises(RuntimeError, match="negative"):
        dryrun.Tally().combine([(1, tally(segments=[10])),
                                (-1, tally(segments=[30]))])


def test_only_dtensor_errors_are_read_as_its_limits():
    """A report's error is put behind ``OLD_DTENSOR_LIMITS`` (on a torch
    before 2.13) only where DTensor raised it: not a fault of the port's
    own code, nor the trace's time limit."""
    from torch.distributed.tensor import Shard

    from repro_torch.launch import dryrun

    with pytest.raises(AssertionError) as dtensor:
        Shard(3)._split_tensor(torch.empty(4), 2)
    assert dryrun.raised_in_dtensor(dtensor.value)
    with pytest.raises(TypeError) as ours:
        dryrun.tree_local_bytes(None, None)
    assert not dryrun.raised_in_dtensor(ours.value)
    with pytest.raises(TimeoutError) as late:
        with dryrun._time_limit(0.01):
            while True:
                pass
    assert not dryrun.raised_in_dtensor(late.value)


def test_peak_is_the_hand_count_of_an_mlp():
    """The recorder's peak of live bytes on a gated MLP's forward (plain
    ``meta`` tensors, fp32, B S D F = 2 4 8 32): the gate, the up
    projection, the activation and the product are alive together, 4 x B
    S F x 4 bytes, more than the three and the output at the end."""
    from repro_torch.launch import dryrun
    from repro_torch.models import layers

    B, S, D, F = 2, 4, 8, 32
    x = torch.empty(B, S, D, device="meta")
    p = {"w_gate": torch.empty(D, F, device="meta"),
         "w_up": torch.empty(D, F, device="meta"),
         "w_down": torch.empty(F, D, device="meta")}
    tally = dryrun.Tally()
    tally.hold([x, *p.values()])
    with dryrun._step_trace_mode(tally, {}):
        y = layers.mlp(p, x)
    assert y.shape == (B, S, D)
    assert tally.peak == 4 * B * S * F * 4
    assert tally.peak > 3 * B * S * F * 4 + B * S * D * 4


def test_row_parallel_w_down_reduces_the_residual_once():
    """The MLP block of a reduced yi-9b in fp32 on a (1, 4) mesh, x
    replicated: w_gate / w_up split d_ff over 'model' and w_down is
    row-parallel, so the block's output is a partial sum, which the norm
    that reads it needs whole. Exactly one collective moves the [B, S, D]
    partial sum, with its byte count: DTensor reduce-scatters it and runs
    the norm on the scattered part (GSPMD all-reduces it); the only other
    collective gathers the norm's per-row statistic."""
    out = _run("""
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch.models import layers
        from repro_torch.sharding import specs as sh
        mesh = fake_mesh((1, 4))
        cfg = shapes._dryrun_cfg("yi-9b").reduced().replace(
            param_dtype="float32", dtype="float32")
        B, S, D = 4, 32, cfg.d_model
        p = sh.distribute(layers.init_mlp(layers.MetaGenerator(), cfg),
                          sh.param_specs({"mlp": layers.init_mlp(
                              layers.MetaGenerator(), cfg)}, mesh, cfg)["mlp"],
                          mesh)
        x = sh.distribute(torch.empty(B, S, D, device="meta"), (None,) * 3, mesh)
        ln = sh.distribute(torch.empty(D, device="meta"), (None,), mesh)
        tally = dryrun.Tally()
        dims = {mesh.get_group(i).group_name: n
                for i, n in enumerate(mesh.mesh_dim_names)}
        with dryrun._step_trace_mode(tally, dims), implicit_replication():
            y = layers.rms_norm(x + layers.mlp(p, x), ln)
        print("JSON" + json.dumps({"coll": tally.records(),
                                   "bsd": B * S * D * 4,
                                   "w_down": list(map(str, p["w_down"].placements))}))
    """)
    big = [r for r in out["coll"] if r["bytes"] == out["bsd"]]
    assert big in ([{"kind": "reduce-scatter", "mesh_dim": "model", "count": 1,
                     "bytes": out["bsd"]}],
                   [{"kind": "all-reduce", "mesh_dim": "model", "count": 1,
                     "bytes": out["bsd"]}])
    rest = [r for r in out["coll"] if r["bytes"] != out["bsd"]]
    assert all(r["kind"] == "all-gather" and r["bytes"] <= out["bsd"] // 256
               for r in rest), rest
    assert out["w_down"] == ["S(1)", "S(0)"]


def test_perf_overrides_give_the_reference_specs():
    """embed_dp and cache_nosplit as overrides passed in give the specs the
    reference's mutate-and-restore gives, on both production meshes."""
    jax = pytest.importorskip("jax")
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro.sharding import specs as jsh
    from repro_torch.launch import perf, shapes
    from repro_torch.models import build_model, layers
    from repro_torch.sharding import specs as sh

    sys.path.insert(0, str(REPO / "tests"))
    from test_torch_sharding_specs import SIZES, _abstract, _jax_flat, _torch_flat

    for arch in ("gemma-2b", "hymba-1.5b"):
        jcfg = jget(arch).replace(param_dtype="bfloat16", dtype="bfloat16")
        jparams = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
        tcfg = shapes._dryrun_cfg(arch)
        tparams = build_model(tcfg).init(layers.MetaGenerator())
        jc = jax.eval_shape(lambda: jbuild(jcfg).init_cache(128, 32768))
        tc = build_model(tcfg).init_cache(128, 32768, device="meta")
        _, kw = perf.variant_overrides(arch, "decode_32k",
                                       {"embed_dp", "cache_nosplit"}, tcfg)
        for sizes in SIZES.values():
            am = _abstract(sizes)
            old = dict(jsh._RULES)
            jsh._RULES["embed"] = (None, "data")
            jsh._RULES["head"] = ("data", None)
            try:
                want = _jax_flat(jparams, jsh.param_specs(jparams, am, jcfg))
            finally:
                jsh._RULES.clear()
                jsh._RULES.update(old)
            got = _torch_flat(tparams, sh.param_specs(tparams, sizes, tcfg,
                                                      rules=kw["rules"]))
            assert got == want
            assert jsh._RULES["embed"] == ("model", "data")
            ba = jsh.batch_axes(am)

            def nosplit(shape):
                if len(shape) == 5:
                    return (None, ba if jsh._div(shape[1], am, ba) else None,
                            None, None, None)
                return (None,) * len(shape)
            want_c = {k: nosplit(v[0]) for k, v in _jax_flat(
                jc, jsh.cache_specs(jc, am)).items()}
            got_c = {k: v[1] for k, v in _torch_flat(
                tc, sh.cache_specs(tc, sizes, split=kw["cache_split"])).items()}
            assert got_c == want_c


def test_actseq_redistributes_the_residual_stream():
    """actseq on a reduced gemma-2b prefill: the residual stream is split
    over 'model' on its sequence dim at each block, which adds collectives
    the baseline does not have. Each block's norms read it so split, and so
    do the Q/K/V products (the norms keep the splits of the stream's
    owner), as the seqpar variant's embedded tokens are; the baseline's
    norms read it split on its batch alone. The port counts the FLOPs of
    products and attention, whose work the baseline already splits over
    the whole mesh here, so actseq's are no higher."""
    out = _run("""
        from repro_torch.launch import perf
        from repro_torch.models import layers
        mesh = fake_mesh((2, 4))
        spec = ShapeSpec("prefill_32k", "prefill", 32, 4)
        seen = []
        norm, qkv = layers.rms_norm, layers.attention_qkv

        def rms_norm(x, *a):
            seen.append(("norm", str(layers.batch_placed(x).placements)))
            return norm(x, *a)

        def attention_qkv(p, x, *a):
            seen.append(("qkv", str(x.placements)))
            return qkv(p, x, *a)
        layers.rms_norm, layers.attention_qkv = rms_norm, attention_qkv
        res = {}
        for v in ("", "actseq", "seqpar"):
            cfg, kw = perf.variant_overrides("gemma-2b", "prefill_32k",
                                             set(filter(None, [v])),
                                             shapes._dryrun_cfg("gemma-2b").reduced())
            seen.clear()
            res[v or "base"] = tally_dict(dryrun.trace_step(
                "gemma-2b", spec, mesh, cfg, **kw))
            res[v or "base"]["seen"] = list(seen)
        res["layers"] = cfg.n_layers
        print("JSON" + json.dumps(res))
    """)
    assert out["actseq"]["coll"] != out["base"]["coll"]
    assert out["actseq"]["flops"] <= out["base"]["flops"]
    whole, batch = "(Shard(dim=0), Replicate())", "(Shard(dim=0), Shard(dim=1))"
    n = out["layers"]
    for v, want in (("base", whole), ("actseq", batch), ("seqpar", batch)):
        # a block's two norms, then its Q/K/V products' input
        assert out[v]["seen"][:3 * n] == [["norm", want], ["qkv", want],
                                          ["norm", want]] * n, (v, out[v])
