"""Multi-pod dry-run of the port (reference: ``repro.launch.dryrun``).

For every (architecture x input shape x mesh), on the 16x16 single-pod
mesh (256 ranks) and the 2x16x16 multi-pod mesh (512 ranks) of
``launch/mesh.py``: start the ``fake`` process-group backend at that world
size (this process is rank 0; no other rank exists and no byte moves),
take the parameters, optimizer state, batch and cache on ``meta``,
distribute them as DTensors by ``sharding/specs.py``, and run the step of
``launch/shapes.py`` once. DTensor propagates the shardings op by op and
issues the collectives a real rank 0 would issue; a TorchDispatchMode under
DTensor (it declines DTensor ops, so it sees the local ones) records:

- every collective (``_c10d_functional`` and DTensor's all-to-all): kind,
  input bytes and mesh dim -> ``collective_bytes`` / ``collective_counts``
  under the reference's HLO names, and the roofline's collective term;
- the FLOPs of every local op, by ``torch.utils.flop_counter``'s formula
  table (``FlopCounterMode`` itself counts the global DTensor op: the whole
  mesh's work) -> ``cost_analysis.flops`` and ``raw_hlo_flops``;
- the bytes every non-view local op reads and writes -> ``bytes accessed``
  (eager and unfused, so above what a fused program moves).

``memory_analysis`` has the local shards' bytes of the step's arguments and
outputs. ``temp_size_in_bytes`` is null: ``MemTracker`` counts storages
allocated on a device, and a ``meta`` trace allocates none.

Depth probe: each model is traced at depth 1 and 2 (the enc-dec encoder
and decoder each; the xLSTM's mLSTM and sLSTM blocks each), and the counts
are extrapolated linearly to full depth. DTensor decides each op's
sharding on its own, so the layers of one kind issue the same collectives;
a stacked ``[L, ...]`` parameter's gradient is reduced once, at L times a
layer's bytes. Collectives are therefore extrapolated as counts and bytes
per kind and mesh dim, which is exact, as are the FLOPs and output bytes
(``tests/test_torch_dryrun.py`` holds them to a full trace); the bytes
accessed also count DTensor's own local helpers of a redistribution, which
do not scale with depth, and are within 1% of a full trace. The K6 and K7 plain versions and the xLSTM recurrences run
shard by shard (``sharding/shardwise.py``), so their loops see plain
``meta`` shards. A DTensor op without a sharding strategy fails its
(arch, shape, mesh), which is written as ``ok: false`` with the error.

Reports go to ``results/dryrun_torch/<arch>__<shape>__<mesh>.json`` with the
reference's keys; the roofline uses the H100 constants. Given more than
one (arch, shape, mesh), the CLI runs each in a process of its own: the
fake group is global to a process, and DTensor keeps sharding decisions
across configurations (in one process olmoe-1b-7b's top-8 routing was
reused for deepseek-moe-16b's top-6).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
      --shape decode_32k --both-meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--skip-done] \\
      [--multi-pod | --both-meshes] [--timeout SECONDS]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import signal
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import LANGUAGE
from repro_torch.launch import roofline as rl
from repro_torch.launch.shapes import SHAPES, _dryrun_cfg, build_lowerable
from repro_torch.sharding import specs as sh
from repro_torch.sharding.shardwise import is_dtensor

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
MESHES = {False: ("pod16x16", 256), True: ("pod2x16x16", 512)}

# local collective ops -> the reference's HLO names
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}


def _out_path(arch: str, shape: str, mesh_name: str) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    return os.path.join(RESULTS_DIR, f"{arch}__{shape}__{mesh_name}.json")


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def tree_local_bytes(tree) -> int:
    """Bytes of the local shards of a tree's tensor leaves."""
    return sum(_nbytes(_local(x)) for x in tree_lib.leaves(tree))


class Tally:
    """What one traced step did on rank 0: FLOPs, bytes accessed, output
    bytes, and its collectives' counts and input bytes per (kind, mesh
    dim)."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.out_bytes = 0
        self.view_copies = 0
        self.coll_count: collections.Counter = collections.Counter()
        self.coll_bytes: collections.Counter = collections.Counter()

    def record(self, kind: str, nbytes: int, dim: str) -> None:
        self.coll_count[(kind, dim)] += 1
        self.coll_bytes[(kind, dim)] += nbytes

    def combine(self, terms: List[Tuple[int, "Tally"]]) -> "Tally":
        """sum(c * tally) over (c, tally): the depth extrapolation."""
        out = Tally()
        for c, t in terms:
            out.flops += c * t.flops
            out.bytes += c * t.bytes
            out.out_bytes += c * t.out_bytes
            out.view_copies += c * t.view_copies
            for k in t.coll_count:
                out.coll_count[k] += c * t.coll_count[k]
                out.coll_bytes[k] += c * t.coll_bytes[k]
        bad = {k: n for k, n in out.coll_count.items() if n < 0}
        if bad:
            raise RuntimeError(f"depth probe extrapolated negative counts {bad}")
        out.coll_count, out.coll_bytes = +out.coll_count, +out.coll_bytes
        return out

    def records(self) -> List[dict]:
        return [{"kind": k, "mesh_dim": d, "count": n,
                 "bytes": self.coll_bytes[(k, d)]}
                for (k, d), n in sorted(self.coll_count.items())]


def _step_trace_mode(tally: Tally, group_dims: Dict[str, str]):
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class StepTrace(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented       # let DTensor lower it to local ops
            kwargs = kwargs or {}
            try:
                out = func(*args, **kwargs)
            except RuntimeError as e:
                if func is not torch.ops.aten.view.default or "view size" not in str(e):
                    raise
                # a reshape DTensor ruled a view on its global strides, while
                # the local shard is laid out otherwise (a permuted gradient):
                # copy, as eager reshape does, and count it
                out = args[0].reshape(args[1])
                tally.view_copies += 1
                tally.bytes += 2 * _nbytes(out)
                return out
            outs = out if isinstance(out, (list, tuple)) else [out]
            if any(isinstance(o, FakeTensor) for o in outs):
                return out              # DTensor's shape inference, not the step
            name = func._overloadpacket.__name__
            if func.namespace in ("_c10d_functional", "_dtensor"):
                if name in _NOT_COLLECTIVES:
                    return out
                kind = _KINDS[name]
                inp = args[0]
                nb = (sum(_nbytes(t) for t in inp) if isinstance(inp, (list, tuple))
                      else _nbytes(inp))
                group = args[-1] if isinstance(args[-1], str) else kwargs.get("group_name")
                tally.record(kind, nb, group_dims.get(group) or _group_label(group))
                return out
            f = flop_registry.get(func._overloadpacket)
            if f is not None:
                tally.flops += int(f(*args, **kwargs, out_val=out))
            if not func.is_view:
                tally.bytes += sum(_nbytes(t) for t in (*args, *kwargs.values(), *outs))
            return out

    return StepTrace()


def _group_label(group_name: str) -> str:
    """A collective's group that is no mesh dim's (DTensor flattens mesh
    dims into a new group for one collective over them): its size, which
    is the same in every trace, where its name is not."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    return f"group{_resolve_process_group(group_name).size()}"


def start_fake_world(world: int) -> None:
    """The ``fake`` backend at ``world`` ranks, this process rank 0 (any
    earlier group is destroyed first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def trace_step(arch: str, shape, mesh, cfg, **build_kw) -> Tally:
    """Distribute the step's args for ``cfg`` on ``mesh`` and run it once
    under the recording mode. ``shape`` a ``SHAPES`` name or a
    ``ShapeSpec``."""
    from torch.distributed.tensor.experimental import implicit_replication

    fn, args, shardings = _build(arch, shape, cfg, **build_kw)
    dargs = tuple(sh.distribute(a, p, mesh) for a, p in zip(args, shardings(mesh)))
    group_dims = {mesh.get_group(i).group_name: name
                  for i, name in enumerate(mesh.mesh_dim_names)}
    tally = Tally()
    with _step_trace_mode(tally, group_dims), implicit_replication():
        out = fn(*dargs)
    tally.out_bytes = tree_local_bytes(out)
    return tally


def _build(arch, shape, cfg, **build_kw):
    if isinstance(shape, str):
        return build_lowerable(arch, shape, cfg=cfg, **build_kw)
    return build_lowerable(arch, shape.name, cfg=cfg, shape=shape, **build_kw)


def depth_probes(cfg) -> List[Tuple[int, object]]:
    """(coefficient, probe config) pairs whose combination of traced counts
    is the full-depth count: linear in each kind of layer."""
    if cfg.family == "encdec":
        Le, Ld = cfg.n_enc_layers, cfg.n_layers
        return [(3 - Le - Ld, cfg.replace(n_enc_layers=1, n_layers=1)),
                (Le - 1, cfg.replace(n_enc_layers=2, n_layers=1)),
                (Ld - 1, cfg.replace(n_enc_layers=1, n_layers=2))]
    if cfg.family == "ssm" and cfg.slstm_every:
        from repro_torch.models.xlstm import is_slstm
        ns = sum(is_slstm(cfg, i) for i in range(cfg.n_layers))
        nm = cfg.n_layers - ns
        # depth 1: one mLSTM; 2: two; slstm_every: the first sLSTM joins
        k = cfg.slstm_every
        return [(2 - nm + ns * (k - 3), cfg.replace(n_layers=1)),
                (nm - 1 - ns * (k - 2), cfg.replace(n_layers=2)),
                (ns, cfg.replace(n_layers=k))]
    L = cfg.n_layers
    return [(2 - L, cfg.replace(n_layers=1)), (L - 1, cfg.replace(n_layers=2))]


def probe_step(arch: str, shape, mesh, cfg, **build_kw) -> Tally:
    """The full-depth tally of ``cfg``'s step from its depth probes. The
    smallest probe is traced once first and not counted: the first call of
    an op in a process can run its decomposition through DTensor's
    sharding propagation, which the recorder would see."""
    probes = [(c, p) for c, p in depth_probes(cfg) if c]
    trace_step(arch, shape, mesh, probes[0][1], **build_kw)
    return Tally().combine([(c, trace_step(arch, shape, mesh, p, **build_kw))
                            for c, p in probes])


def argument_bytes(arch: str, shape, mesh, cfg, **build_kw) -> int:
    """Bytes of the local shards of the step's arguments at full depth
    (from the shard shapes; nothing is traced)."""
    _, args, shardings = _build(arch, shape, cfg, **build_kw)
    return sum(tree_local_bytes(sh.distribute(a, p, mesh))
               for a, p in zip(args, shardings(mesh)))


def make_report(arch: str, shape, mesh, mesh_name: str, cfg, *,
                flash: bool = False, verbose: bool = True, **build_kw) -> dict:
    """The report of one (arch, shape, mesh): the reference's keys."""
    t0 = time.time()
    arg_bytes = argument_bytes(arch, shape, mesh, cfg, **build_kw)
    t_lower = time.time() - t0
    tally = probe_step(arch, shape, mesh, cfg, **build_kw)
    t_trace = time.time() - t0 - t_lower
    coll = rl.collective_bytes(tally.records())
    cost = {"flops": float(tally.flops), "bytes accessed": float(tally.bytes),
            "transcendentals": None}
    roof = rl.build(arch, shape, mesh_name, mesh.size(), cost, coll, flash=flash)
    mem_d = {"generated_code_size_in_bytes": None,
             "argument_size_in_bytes": arg_bytes,
             "output_size_in_bytes": tally.out_bytes,
             "temp_size_in_bytes": None,
             "alias_size_in_bytes": None}
    shape_name = shape if isinstance(shape, str) else shape.name
    report = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": mesh.size(), "ok": True,
        "lower_s": round(t_lower, 2), "compile_s": round(t_trace, 2),
        "memory_analysis": mem_d,
        "cost_analysis": cost,
        "collective_bytes": {k: v for k, v in coll.items() if k != "_counts"},
        "collective_counts": coll["_counts"],
        "roofline": roof.to_dict(),
    }
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] OK "
              f"setup={t_lower:.1f}s trace={t_trace:.1f}s "
              f"(local views copied: {tally.view_copies})", flush=True)
        print(f"  memory_analysis: {mem_d}")
        print(f"  cost_analysis:   flops={tally.flops:.3e} bytes={tally.bytes:.3e}")
        print(f"  collectives:     {report['collective_bytes']}")
        print(f"  collective counts: {report['collective_counts']}")
        print(f"  roofline:        compute={roof.compute_s:.4g}s "
              f"memory={roof.memory_s:.4g}s collective={roof.collective_s:.4g}s "
              f"dominant={roof.dominant}", flush=True)
    return report


def production_mesh(multi_pod: bool):
    """The fake world and the production mesh over it: (mesh, its name)."""
    from repro_torch.launch.mesh import make_production_mesh

    mesh_name, world = MESHES[multi_pod]
    start_fake_world(world)
    return make_production_mesh(multi_pod=multi_pod), mesh_name


def run_one(arch: str, shape: str, multi_pod: bool, verbose: bool = True,
            cfg=None, write: bool = True) -> dict:
    mesh, mesh_name = production_mesh(multi_pod)
    report = make_report(arch, shape, mesh, mesh_name, cfg or _dryrun_cfg(arch),
                         verbose=verbose)
    if write:
        with open(_out_path(arch, shape, mesh_name), "w") as f:
            json.dump(report, f, indent=2)
    return report


@contextlib.contextmanager
def _time_limit(seconds: float):
    """Raise TimeoutError in this (main) thread after ``seconds`` (0: never)."""
    if not seconds:
        yield
        return

    def expire(*_):
        raise TimeoutError(f"trace took over {seconds:g} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _run_and_record(arch: str, shape: str, multi_pod: bool, timeout: float) -> bool:
    """run_one in this process; a failure is written as an ``ok: false``
    report, as the reference writes it. Returns whether it was ok."""
    path = _out_path(arch, shape, MESHES[multi_pod][0])
    t0 = time.time()
    try:
        with _time_limit(timeout):
            run_one(arch, shape, multi_pod)
        return True
    except Exception as e:  # noqa: BLE001
        traceback.print_exc()
        with open(path, "w") as f:
            json.dump({"arch": arch, "shape": shape,
                       "mesh": MESHES[multi_pod][0], "ok": False,
                       "error": repr(e), "seconds": round(time.time() - t0, 2)},
                      f, indent=2)
        return False


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--timeout", type=float, default=0,
                    help="seconds an (arch, shape, mesh) may take before it "
                         "is written as failed (0: no limit)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else LANGUAGE
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    todo = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = MESHES[mp][0]
                if args.skip_done and os.path.exists(_out_path(arch, shape, mesh_name)):
                    print(f"[{arch} x {shape} x {mesh_name}] cached, skipping")
                    continue
                todo.append((arch, shape, mp))
    if len(todo) == 1:
        raise SystemExit(0 if _run_and_record(*todo[0], args.timeout) else 1)

    # one process each: the fake group is global to a process, and DTensor
    # keeps sharding decisions across configs that a later one must not
    # reuse (a top-k of another k, say)
    failures = []
    for arch, shape, mp in todo:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--timeout", str(args.timeout)]
        if subprocess.run(cmd + (["--multi-pod"] if mp else [])).returncode:
            failures.append((arch, shape, MESHES[mp][0]))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f3 in failures:
            print("  ", f3)
        raise SystemExit(1)
    print("\nall dry-runs OK")


if __name__ == "__main__":
    main()
