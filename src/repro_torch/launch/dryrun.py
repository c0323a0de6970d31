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
outputs, and ``temp_size_in_bytes``: the peak of the local bytes alive
beside the arguments during the step. The recorder counts each storage a
local op makes (a view's storage is its base's, counted once) until it is
freed, which a ``meta`` storage reports as a real one does; what autograd
saves for the backward stays alive with it, and outputs alive at the peak
count. K6's and K7's plain versions stand in for the kernels with only
their outputs counted (``shardwise.stand_in``). This is the port's eager,
unfused reading of one rank's step, not XLA's buffer assignment, and is
not compared with the reference's number.

The step's outputs are materialised as a compiled step's are: no leaf
carries a partial sum (``shapes.materialised``), and a replaced K/V cache
is placed as the cache was (``layers.placed_like``).

Depth probe: each model is traced at depth 4 and 6 (3 and 5 for an odd
depth; the enc-dec encoder and decoder each; the xLSTM at 2, 3 and its
first sLSTM's depth: :func:`depth_probes`), and the counts are
extrapolated linearly to full depth. DTensor decides
each op's sharding on its own, so the layers of one kind issue the same
collectives; a stacked ``[L, ...]`` parameter's gradient is reduced once,
at L times a layer's bytes. Collectives are therefore extrapolated as
counts and bytes per kind and mesh dim, which is exact, as are the FLOPs
and output bytes (``tests/test_torch_dryrun.py`` holds them to a full
trace). The peak is extrapolated a segment of the step at a time (the
forward, the backward, each leaf's update, the encoder:
``shardwise.phase_mark``) and is within 1% of a full trace. The bytes
accessed also count DTensor's own local helpers of a redistribution,
which do not scale with depth, and are within 1% of a full trace. The K6 and K7 plain versions and the xLSTM recurrences run
shard by shard (``sharding/shardwise.py``), so their loops see plain
``meta`` shards, and there two steps stand for all
(``shardwise.FoldedLoop``: a step in the middle counted S times, its
backward too, and what a step keeps alive S times in the peak). A DTensor op without a sharding strategy fails its
(arch, shape, mesh), which is written as ``ok: false`` with the error
(an error DTensor raised behind :data:`OLD_DTENSOR_LIMITS` on a torch
before 2.13).

The step splits its tokens over the batch axes as the reference's does:
a weight is gathered over the mesh dims that split the batch it meets
(``layers.dense`` and ``layers.embed``, FSDP's unshard at use; GSPMD
gathers a weight whose d_model the rules split over 'data' there), a
mesh dim that neither a product's weight nor its input splits takes the
batch, or else the contraction (``layers.dense``), and a norm reads the
residual stream split on its batch and whole on every other mesh dim,
its gradient too (``layers.batch_placed``). Without them DTensor keeps
the weights split, contracts over their d_model shards and repeats the
whole batch's attention and FFN on every 'data' rank. A rank's FLOPs
are its share of the step's (``tools/dryrun_share.py``); its collectives
stay DTensor's own.

Placements DTensor resolves directly. A split or merge of heads that
would be uneven first moves the offending shard (``layers.split_heads``).
On the 3-D mesh, where DTensor plans a strided shard's redistributions by
a graph search that took minutes an op
(``shardwise.strided_shards_search``), strided shards are kept out of the
step: each block's output takes its gradient as it is placed
(``layers.grad_as_value``), the decode attention runs shard by shard, and
a matmul that folds ``[B, S]`` first gathers a split sequence dim or an
uneven batch split (:func:`_unfolded_matmuls`).

Reports go to ``results/dryrun_torch/<arch>__<shape>__<mesh>.json`` with the
reference's keys; the roofline uses the H100 constants. Given more than
one (arch, shape, mesh), the CLI runs each in a process of its own: the
fake group is global to a process, and DTensor keeps sharding decisions
across configurations (in one process olmoe-1b-7b's top-8 routing was
reused for deepseek-moe-16b's top-6).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
      --shape decode_32k --both-meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--skip-done] \\
      [--multi-pod | --both-meshes] [--timeout SECONDS] [--jobs N]
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import itertools
import json
import os
import signal
import subprocess
import sys
import time
import traceback
import weakref
from typing import Dict, List, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import LANGUAGE
from repro_torch.launch import roofline as rl
from repro_torch.launch.shapes import SHAPES, _dryrun_cfg, build_lowerable
from repro_torch.sharding import specs as sh
from repro_torch.sharding.shardwise import is_dtensor, strided_shards_search

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
        self.segments: List[int] = []     # peak live bytes between marks
        self.view_copies = 0
        self.coll_count: collections.Counter = collections.Counter()
        self.coll_bytes: collections.Counter = collections.Counter()
        self.allocations = 0              # storages counted so far
        # a live storage -> [the bytes it counts for, its allocation's serial]
        self._live: Dict[int, List[int]] = {}
        self._live_bytes = 0
        self._seg_peak = 0
        self._window_peak = 0

    @property
    def peak(self) -> int:
        return max(self.segments + [self._seg_peak])

    def mark(self) -> None:
        """Close the current segment of the step (``shardwise.phase_mark``:
        the forward, the backward, each leaf's update), so that the depth
        probes extrapolate each segment's peak and take the largest: a
        step's peak moves between segments as the depth grows."""
        self.segments.append(self._seg_peak)
        self._seg_peak = self._live_bytes

    def record(self, kind: str, nbytes: int, dim: str) -> None:
        self.coll_count[(kind, dim)] += 1
        self.coll_bytes[(kind, dim)] += nbytes

    def hold(self, tensors) -> None:
        """Count the storages of ``tensors`` (a step's arguments' local
        shards) as live for the whole trace, outside the peak."""
        for t in tensors:
            self._live.setdefault(t.untyped_storage()._cdata, [0, -1])

    def allocate(self, t) -> None:
        """Count ``t``'s storage, if new, as live until it is freed, and
        keep the peak of the live bytes (a view's storage is its base's,
        counted once)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = [n, self.allocations]
        self.allocations += 1
        self._live_bytes += n
        self._seg_peak = max(self._seg_peak, self._live_bytes)
        self._window_peak = max(self._window_peak, self._live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key)[0]

    def window(self) -> int:
        """Start following the peak of live bytes afresh; returns the
        serial the next allocation takes."""
        self._window_peak = self._live_bytes
        return self.allocations

    def repeat_storages(self, first: int, last: int, k: int) -> None:
        """Count each storage allocated from serial ``first`` up to ``last``
        (a folded loop's first step) that is still alive (it outlived the
        next step: an output kept, or a tensor saved for the backward) ``k``
        more times until it is freed. Those storages were alive since
        ``last``, so the peak since :meth:`window` rises by the same bytes
        (``shardwise.FoldedLoop``)."""
        extra = 0
        for entry in self._live.values():
            if first <= entry[1] < last:
                extra += k * entry[0]
                entry[0] *= k + 1
        self._live_bytes += extra
        self._seg_peak = max(self._seg_peak, self._window_peak + extra)

    def combine(self, terms: List[Tuple[int, "Tally"]]) -> "Tally":
        """sum(c * tally) over (c, tally): the depth extrapolation. The
        peak is each segment's extrapolated, where the probes have the same
        segments (a per-block parameter list, the xLSTM's, has a leaf update
        a block: there, the peaks as a whole)."""
        out = Tally()
        same = len({len(t.segments) for _, t in terms}) == 1
        for c, t in terms:
            out.flops += c * t.flops
            out.bytes += c * t.bytes
            out.out_bytes += c * t.out_bytes
            segs = t.segments if same else [t.peak]
            out.segments = [a + c * b for a, b in itertools.zip_longest(
                out.segments, segs, fillvalue=0)]
            out.view_copies += c * t.view_copies
            for k in t.coll_count:
                out.coll_count[k] += c * t.coll_count[k]
                out.coll_bytes[k] += c * t.coll_bytes[k]
        bad = {k: n for k, n in out.coll_count.items() if n < 0}
        bad.update({k: n for k, n in (
            ("flops", out.flops), ("bytes", out.bytes),
            ("out_bytes", out.out_bytes),
            *((("peak", i), b) for i, b in enumerate(out.segments)),
            *(((k, "bytes"), b) for k, b in out.coll_bytes.items())) if n < 0})
        if bad:
            raise RuntimeError(f"depth probe extrapolated negative terms {bad}")
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
        # read by the hooks of sharding/shardwise.py: the step's segments,
        # a folded loop's step count, a kernel stand-in's depth
        def __init__(self):
            super().__init__()
            self.tally = tally
            self.repeat = 1
            self.untracked = 0

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
                tally.view_copies += self.repeat
                tally.bytes += 2 * _nbytes(out) * self.repeat
                self._allocate([out])
                return out
            outs = out if isinstance(out, (list, tuple)) else [out]
            if any(isinstance(o, FakeTensor) for o in outs):
                return out              # DTensor's shape inference, not the step
            self._allocate(outs)
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
                tally.flops += int(f(*args, **kwargs, out_val=out)) * self.repeat
            if not func.is_view:
                tally.bytes += self.repeat * sum(
                    _nbytes(t) for t in (*args, *kwargs.values(), *outs))
            return out

        def _allocate(self, outs):
            if not self.untracked:
                for o in outs:
                    if isinstance(o, torch.Tensor):
                        tally.allocate(o)

    return StepTrace()


def _unfolded_matmuls():
    """A TorchFunctionMode for the traced step: ``x @ w`` of a DTensor
    activation ``x`` [B, ..., D] (ndim >= 3) and a weight matrix first
    moves any mesh dim that splits one of x's inner token dims (the
    sequence) to a replica, and places the product's gradient alike
    (:func:`repro_torch.models.layers.tokens_whole`). The product folds
    ``[B, S]`` into one dim, and a split sequence dim would become a
    strided shard there, whose redistributions DTensor plans by a graph
    search: minutes an op on the 3-D mesh."""
    from torch.overrides import TorchFunctionMode

    from repro_torch.models import layers

    mm = {torch.Tensor.matmul, torch.Tensor.__matmul__, torch.matmul}

    class UnfoldedMatmuls(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if (func in mm and len(args) == 2 and is_dtensor(args[0])
                    and args[0].ndim >= 3 and getattr(args[1], "ndim", 0) == 2):
                x = layers.tokens_whole(args[0])
                return layers.tokens_whole(func(x, args[1], **kwargs),
                                           grad_only=True)
            return func(*args, **kwargs)

    return UnfoldedMatmuls()


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
    tally.hold(_local(x) for x in tree_lib.leaves(dargs)
               if isinstance(x, torch.Tensor))
    unfold = (_unfolded_matmuls() if strided_shards_search(mesh)
              else contextlib.nullcontext())
    with _step_trace_mode(tally, group_dims), unfold, implicit_replication():
        out = fn(*dargs)
    tally.mark()
    tally.out_bytes = tree_local_bytes(out)
    return tally


def _build(arch, shape, cfg, **build_kw):
    if isinstance(shape, str):
        return build_lowerable(arch, shape, cfg=cfg, **build_kw)
    return build_lowerable(arch, shape.name, cfg=cfg, shape=shape, **build_kw)


def _stack_probe(L: int) -> Tuple[int, int]:
    """(d, c): a stack of L layers is probed at depths d and d + 2, c the
    coefficient of the deeper probe (the shallower takes 1 - c, less any
    other stack's). d is 4 for an even L, else 3: the first layer reads
    the embedding's placements and the last feeds the head, so only a
    layer between them is placed as the middle of a deep stack is
    (hymba-1.5b's train step on 16x16 gathers 36 times more a layer from
    depth 2 to 3, 38 from 3 on), and DTensor places a stacked parameter's
    gradient by the parity of L (llama3-405b's train step on 2x16x16
    reduce-scatters less at depth 3 than at 2 and 4). A stack no deeper
    than d + 2 is traced whole."""
    d = 4 if L % 2 == 0 else 3
    return (L, 0) if L <= d + 2 else (d, (L - d) // 2)


def depth_probes(cfg) -> List[Tuple[int, object]]:
    """(coefficient, probe config) pairs whose combination of traced counts
    is the full-depth count: linear in each kind of layer
    (:func:`_stack_probe`)."""
    if cfg.family == "encdec":
        (de, ce), (dd, cd) = _stack_probe(cfg.n_enc_layers), _stack_probe(cfg.n_layers)
        return [(1 - ce - cd, cfg.replace(n_enc_layers=de, n_layers=dd)),
                (ce, cfg.replace(n_enc_layers=de + 2, n_layers=dd)),
                (cd, cfg.replace(n_enc_layers=de, n_layers=dd + 2))]
    if cfg.family == "ssm" and cfg.slstm_every:
        from repro_torch.models.xlstm import is_slstm
        ns = sum(is_slstm(cfg, i) for i in range(cfg.n_layers))
        nm = cfg.n_layers - ns
        # depth 2: two mLSTMs; 3: three; slstm_every: the first sLSTM joins
        # (a one-block xLSTM is sharded unlike any deeper one)
        k = cfg.slstm_every
        if k < 4:
            raise ValueError(f"the xLSTM probes need slstm_every >= 4, got {k}")
        return [(3 - nm + ns * (k - 4), cfg.replace(n_layers=2)),
                (nm - 2 + ns * (3 - k), cfg.replace(n_layers=3)),
                (ns, cfg.replace(n_layers=k))]
    d, c = _stack_probe(cfg.n_layers)
    return [(1 - c, cfg.replace(n_layers=d)), (c, cfg.replace(n_layers=d + 2))]


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
             "temp_size_in_bytes": tally.peak,
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


#: what a report's error starts with where DTensor of a torch before 2.13
#: refused the step (``tests/test_torch_dryrun.py`` skips those cases there)
OLD_DTENSOR_LIMITS = (
    "DTensor before torch 2.13 refused this step (it cannot redistribute "
    "Shard to Partial, cannot flatten a sharded sequence dim, and refuses "
    "most ops on a dim split over two mesh dims)")


def before_torch_2_13() -> bool:
    major, minor = (int(x) for x in torch.__version__.split("+")[0].split(".")[:2])
    return (major, minor) < (2, 13)


def raised_in_dtensor(e: BaseException) -> bool:
    """Whether ``e`` was raised by DTensor itself: the innermost frame of
    its traceback is in ``torch.distributed.tensor`` (a sharding rule or a
    redistribution), not in the port or in a local op."""
    tb, module = e.__traceback__, ""
    while tb is not None:
        module = tb.tb_frame.f_globals.get("__name__", "")
        tb = tb.tb_next
    return module.startswith("torch.distributed.tensor")


def _run_and_record(arch: str, shape: str, multi_pod: bool, timeout: float) -> bool:
    """run_one in this process; a failure is written as an ``ok: false``
    report, as the reference writes it. On a torch before 2.13, an error
    DTensor raised (:func:`raised_in_dtensor`) is put behind
    :data:`OLD_DTENSOR_LIMITS`. Returns whether it was ok."""
    path = _out_path(arch, shape, MESHES[multi_pod][0])
    t0 = time.time()
    try:
        with _time_limit(timeout):
            run_one(arch, shape, multi_pod)
        return True
    except Exception as e:  # noqa: BLE001
        traceback.print_exc()
        error = repr(e)
        if before_torch_2_13() and raised_in_dtensor(e):
            error = f"{OLD_DTENSOR_LIMITS}: {error}"
        with open(path, "w") as f:
            json.dump({"arch": arch, "shape": shape,
                       "mesh": MESHES[multi_pod][0], "ok": False,
                       "error": error, "seconds": round(time.time() - t0, 2)},
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
    ap.add_argument("--jobs", type=int, default=1,
                    help="configurations traced at once, a process each")
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
    def run(job):
        arch, shape, mp = job
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--timeout", str(args.timeout)]
        return subprocess.run(cmd + (["--multi-pod"] if mp else [])).returncode

    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        rcs = list(pool.map(run, todo))
    failures = [(arch, shape, MESHES[mp][0])
                for (arch, shape, mp), rc in zip(todo, rcs) if rc]
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f3 in failures:
            print("  ", f3)
        raise SystemExit(1)
    print("\nall dry-runs OK")


if __name__ == "__main__":
    main()
