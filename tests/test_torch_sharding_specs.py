"""The port's sharding rules (``repro_torch.sharding.specs``) against the
reference's (``repro.sharding.specs``): every parameter, batch and cache
leaf of the ten language models and sdxl-dit gets the same spec on the
production meshes; the reference's own spot checks pass on the port; and
each rank's shard of a reduced olmoe starts at the global offset where JAX
puts that device's shard on an 8-device (2, 2, 2) mesh: one fake rank at
a time, each through DTensor's own offset computation."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.sharding import specs as jsh  # noqa: E402
from repro_torch.configs import LANGUAGE, get_config  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.models.diffusion import dit as tdit  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent

SIZES = {"pod16x16": {"data": 16, "model": 16},
         "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _abstract(sizes):
    names, shape = tuple(sizes), tuple(sizes.values())
    try:
        return AbstractMesh(shape, names)
    except TypeError:                      # jax 0.4.x
        return AbstractMesh(tuple(zip(names, shape)))


def _norm(spec, ndim):
    """A PartitionSpec (or the port's tuple) as one entry per dim."""
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def _jax_flat(tree, specs):
    """{path: (shape, spec)} of a JAX tree and its spec tree (dict keys and
    list indices, as the port's trees)."""
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for (path, leaf), spec in zip(flat, spec_leaves):
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        shape = tuple(getattr(leaf, "shape", ()))
        out[key] = (shape, _norm(spec, len(shape)))
    return out


def _torch_flat(tree, specs, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k in tree:
            out.update(_torch_flat(tree[k], specs[k], prefix + (k,)))
    elif isinstance(tree, (list, tuple)):
        for i, (t, s) in enumerate(zip(tree, specs)):
            out.update(_torch_flat(t, s, prefix + (i,)))
    else:
        shape = tuple(tree.shape) if isinstance(tree, torch.Tensor) else ()
        out[prefix] = (shape, _norm(specs, len(shape)))
    return out


def _jax_params(arch):
    if arch == "sdxl-dit":
        from repro.models.diffusion import dit as jdit
        cfg = jget(arch)
        return cfg, jax.eval_shape(lambda k: jdit.init_params(k, cfg),
                                   jax.random.PRNGKey(0))
    cfg = jget(arch).replace(param_dtype="bfloat16", dtype="bfloat16")
    return cfg, jax.eval_shape(jbuild(cfg).init, jax.random.PRNGKey(0))


def _torch_params(arch):
    if arch == "sdxl-dit":
        cfg = get_config(arch)
        return cfg, tdit.init_params(layers.MetaGenerator(), cfg)
    cfg = tshapes._dryrun_cfg(arch)
    return cfg, build_model(cfg).init(layers.MetaGenerator())


@pytest.mark.parametrize("mesh_name", list(SIZES))
@pytest.mark.parametrize("arch", LANGUAGE + ["sdxl-dit"])
def test_param_specs_match_reference(arch, mesh_name):
    sizes = SIZES[mesh_name]
    jcfg, jparams = _jax_params(arch)
    tcfg, tparams = _torch_params(arch)
    want = _jax_flat(jparams, jsh.param_specs(jparams, _abstract(sizes), jcfg))
    got = _torch_flat(tparams, sh.param_specs(tparams, sizes, tcfg))
    assert got == want
    assert all(leaf.device.type == "meta" for leaf in _leaves(tparams))


def _leaves(tree):
    from repro_torch import tree as tree_lib
    return tree_lib.leaves(tree)


@pytest.mark.parametrize("arch", LANGUAGE)
def test_batch_and_cache_specs_match_reference(arch):
    """``batch_specs`` and ``cache_specs`` on every ``SHAPES`` struct the
    dry-run builds, on both meshes."""
    jcfg = jget(arch).replace(param_dtype="bfloat16", dtype="bfloat16")
    jmodel = jbuild(jcfg)
    tcfg = tshapes._dryrun_cfg(arch)
    tmodel = build_model(tcfg)
    for shape in jshapes.SHAPES.values():
        tshape = tshapes.SHAPES[shape.name]
        jb = jshapes.batch_structs(jcfg, jmodel, shape)
        tb = tshapes.batch_structs(tcfg, tmodel, tshape)
        window = jshapes.decode_window(jcfg, shape)
        jc = jax.eval_shape(lambda: jmodel.init_cache(
            shape.batch, shape.seq, window=window,
            **({"src_len": shape.seq} if jcfg.family == "encdec" else {})))
        tc = tmodel.init_cache(tshape.batch, tshape.seq, window=window,
                               src_len=tshape.seq if tcfg.family == "encdec" else 0,
                               device="meta")
        for mesh_name, sizes in SIZES.items():
            am = _abstract(sizes)
            for seq_axis in (None, "model"):
                assert (_torch_flat(tb, sh.batch_specs(tb, sizes, seq_axis=seq_axis))
                        == _jax_flat(jb, jsh.batch_specs(jb, am, seq_axis=seq_axis))), \
                    (shape.name, mesh_name, seq_axis)
            # specs only: a VLM's ring pins its vision tokens before the
            # window in the port (lm._pinned), so its T is longer
            got = _torch_flat(tc, sh.cache_specs(tc, sizes))
            want = _jax_flat(jc, jsh.cache_specs(jc, am))
            assert ({k: v[1] for k, v in got.items()}
                    == {k: v[1] for k, v in want.items()}), (shape.name, mesh_name)


MESH = SIZES["pod16x16"]
MESH3 = SIZES["pod2x16x16"]


def _specs_for(arch):
    cfg, params = _torch_params(arch)
    return cfg, params, sh.param_specs(params, MESH, cfg)


def test_dense_rules_llama():
    cfg, params_s, specs = _specs_for("llama3-405b")
    b = specs["blocks"]
    assert b["attn"]["wq"] == (None, "data", "model")      # 128 heads: sharded
    # kv heads (8) don't divide model axis (16): replicated output dim
    assert b["attn"]["wk"] == (None, "data", None)
    assert b["attn"]["wv"] == (None, "data", None)
    assert b["mlp"]["w_down"] == (None, "model", "data")
    assert specs["embed"] == ("model", "data")
    assert specs["ln_f"] == (None,)


def test_gemma_small_heads_fully_replicated_attention():
    cfg, params_s, specs = _specs_for("gemma-2b")
    b = specs["blocks"]
    assert b["attn"]["wq"] == (None, "data", None)
    assert b["attn"]["wk"] == (None, "data", None)
    assert b["attn"]["wo"] == (None, None, "data")
    assert b["mlp"]["w_up"] == (None, "data", "model")


def test_moe_expert_parallel():
    cfg, params_s, specs = _specs_for("olmoe-1b-7b")
    e = specs["blocks"]["moe"]["experts"]
    assert e["w_gate"] == (None, "model", "data", None)    # experts on model
    assert e["w_down"] == (None, "model", None, "data")
    assert specs["blocks"]["moe"]["router"] == (None, "data", None)


def test_guard_drops_nondivisible():
    assert sh._guard(("model", "data"), (10, 32), MESH) == (None, "data")


def test_batch_specs_multi_pod():
    s = sh.batch_specs({"tokens": torch.empty(256, 4096, device="meta")}, MESH3)
    assert s["tokens"] == (("pod", "data"), None)
    s = sh.batch_specs({"tokens": torch.empty(1, 64, device="meta")}, MESH3)
    assert s["tokens"] == (None, None)                      # batch 1: replicated


def test_cache_specs_kv_vs_seq():
    c = {"k": torch.empty(16, 128, 32768, 16, 64, device="meta")}
    assert sh.cache_specs(c, MESH)["k"] == (None, "data", None, "model", None)
    c = {"k": torch.empty(126, 128, 32768, 8, 128, device="meta")}
    assert sh.cache_specs(c, MESH)["k"] == (None, "data", "model", None, None)


def test_xlstm_heterogeneous_blocks_get_specs():
    cfg, params_s, specs = _specs_for("xlstm-125m")
    assert isinstance(specs["blocks"], list) and len(specs["blocks"]) == 12
    assert specs["blocks"][0]["w_up"] == ("data", "model")
    assert specs["blocks"][3]["w_x"] == ("data", "model")


def test_placements_and_local_shape():
    from torch.distributed.tensor import Replicate, Shard
    assert sh.placements((("pod", "data"), None, "model"), MESH3) == [
        Shard(0), Shard(0), Shard(2)]
    assert sh.placements((None, "data"), MESH) == [Shard(1), Replicate()]
    assert sh.local_shape((256, 4096, 64), (("pod", "data"), None, "model"),
                          MESH3) == (8, 4096, 4)
    with pytest.raises(ValueError, match="mesh order"):
        sh.placements((("data", "pod"),), MESH3)


def test_meta_init_matches_reference_count_and_allocates_nothing():
    """llama3-405b's parameter tree on meta: the reference's eval_shape
    count, every leaf meta (no storage)."""
    jcfg = jget("llama3-405b").replace(param_dtype="bfloat16", dtype="bfloat16")
    jparams = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    want = sum(int(x.size) for x in jax.tree_util.tree_leaves(jparams))
    params = build_model(tshapes._dryrun_cfg("llama3-405b")).init(
        layers.MetaGenerator())
    leaves = _leaves(params)
    assert sum(x.numel() for x in leaves) == want
    assert all(x.is_meta for x in leaves)


# ----------------------------------------------------------------------
# shard offsets: DTensor's placements against JAX's device index map
# ----------------------------------------------------------------------

_JAX_OFFSETS = """
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_config
from repro.models import build_model
from repro.sharding import specs as sh
cfg = get_config("olmoe-1b-7b").reduced()
params = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
devs = np.asarray(jax.devices()[:8]).reshape(2, 2, 2)
mesh = Mesh(devs, ("pod", "data", "model"))
specs = sh.param_specs(params, mesh, cfg)
coords = {d.id: [int(i) for i in np.argwhere(devs == d)[0]] for d in devs.flat}
out = {}
flat, _ = jax.tree_util.tree_flatten_with_path(params)
spec_leaves = jax.tree_util.tree_leaves(
    specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
for (path, leaf), spec in zip(flat, spec_leaves):
    key = "/".join(str(getattr(p, "key", getattr(p, "idx", ""))) for p in path)
    m = NamedSharding(mesh, spec).devices_indices_map(leaf.shape)
    out[key] = {",".join(map(str, coords[d.id])):
                [s.start or 0 for s in idx] for d, idx in m.items()}
print("JSON" + json.dumps(out))
"""

_TORCH_OFFSETS = """
import json
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from repro_torch.configs import get_config
from repro_torch.models import build_model, layers
from repro_torch.sharding import specs as sh
cfg = get_config("olmoe-1b-7b").reduced()
params = build_model(cfg).init(layers.MetaGenerator())
sizes = {"pod": 2, "data": 2, "model": 2}
specs = sh.param_specs(params, sizes, cfg)
def flat(t, s, pre=()):
    if isinstance(t, dict):
        for k in t: yield from flat(t[k], s[k], pre + (k,))
    elif isinstance(t, list):
        for i, (a, b) in enumerate(zip(t, s)): yield from flat(a, b, pre + (i,))
    else:
        yield "/".join(map(str, pre)), t, s
dtensor = {}
for rank in range(8):
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=8)
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=tuple(sizes))
    coord = mesh.get_coordinate()
    for key, leaf, spec in flat(params, specs):
        _, off = compute_local_shape_and_global_offset(
            leaf.shape, mesh, sh.placements(spec, mesh))
        dtensor.setdefault(key, {})[",".join(map(str, coord))] = list(off)
    dist.destroy_process_group()
print("JSON" + json.dumps(dtensor))
"""


def _run(code, env_extra):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), **env_extra}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("JSON")][-1]
    return json.loads(line[4:])


def test_shard_offsets_match_jax_on_eight_devices():
    want = _run(_JAX_OFFSETS, {
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    got = _run(_TORCH_OFFSETS, {})
    assert len(want) > 10
    assert got == want
