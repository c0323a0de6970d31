"""A rank's share of one step's FLOPs on a mesh, in the port's dry-run
(``repro_torch.launch.dryrun``) and, with ``--reference``, in the JAX
package's (XLA's ``cost_analysis`` of the step compiled for forced host
devices). The share is rank 0's FLOPs on the mesh over the same step's
FLOPs on one rank, times the rank count: 1.0 is the step split evenly over
the ranks. By default at full width and depth 1 (one layer; the enc-dec
LM one encoder and one decoder layer) on 16x16 (2x16x16 with
``--multi-pod``): depth 1, since XLA's ``cost_analysis`` counts a
``lax.scan`` body once, so the reference's full-depth reports hold one
layer and the rest.

  PYTHONPATH=src python tools/dryrun_share.py [--configs ARCH:SHAPE ...] \\
      [--multi-pod] [--jobs 5] [--reference] [--src DIR]

``--src`` takes the port from another tree's ``src`` (a parent commit
unpacked with ``git archive``). Prints one grid, an (arch) row and a shape
column each: the port's share, and the reference's in brackets. CPU only;
each port configuration runs in a process of its own (the fake process
group is global to a process), the reference in one.
``tests/test_torch_dryrun_share.py`` calls :func:`port_flops` and
:func:`reference_flops` on reduced configs.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys

ARCHS = ("deepseek-moe-16b", "gemma-2b", "hymba-1.5b", "internvl2-76b",
         "llama3-405b", "minitron-8b", "olmoe-1b-7b", "seamless-m4t-medium",
         "xlstm-125m", "yi-9b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# shared by both programs: the config (reduced, or full width at depth 1),
# the step's shape (a name, or a (kind, seq, batch) ShapeSpec) and the names
# of a mesh's dims
_SETUP = """
import json
from repro{pkg}.launch import shapes
from repro{pkg}.launch.shapes import ShapeSpec

def config(arch, reduced):
    cfg = shapes._dryrun_cfg(arch)
    if reduced:
        return cfg.reduced()
    return cfg.replace(n_layers=1, **({{"n_enc_layers": 1}} if cfg.n_enc_layers else {{}}))

def spec(shape):
    return shape if isinstance(shape, str) else ShapeSpec("tiny", *shape)

def names(mesh_shape):
    return ("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model")
"""

_PORT = _SETUP + """
import torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch import dryrun
torch.set_num_threads(1)

def whole(spec):       # one rank: every leaf whole (torch 2.11 refuses some
    if isinstance(spec, dict):                  # shards over a size-1 dim)
        return {{k: whole(v) for k, v in spec.items()}}
    if isinstance(spec, list):
        return [whole(v) for v in spec]
    return (None,) * len(spec)

arch, cfg, shape = {arch!r}, config({arch!r}, {reduced!r}), spec({shape!r})
flops = []
for mesh_shape in ((1, 1), {mesh!r}):
    kw = ({{"respec": lambda specs: tuple(map(whole, specs))}}
          if mesh_shape == (1, 1) else {{}})
    n = 1
    for m in mesh_shape:
        n *= m
    dryrun.start_fake_world(n)
    mesh = init_device_mesh("cuda", mesh_shape, mesh_dim_names=names(mesh_shape))
    dryrun.trace_step(arch, shape, mesh, cfg, **kw)     # warm-up, as probe_step
    flops.append(dryrun.trace_step(arch, shape, mesh, cfg, **kw).flops)
print("JSON" + json.dumps(flops))
"""

_REFERENCE = _SETUP + """
import jax, numpy as np
from jax.sharding import Mesh
out = []
for arch, shape in {configs!r}:
    fn, args, shardings = shapes.build_lowerable(
        arch, shape if isinstance(shape, str) else "tiny",
        cfg=config(arch, {reduced!r}),
        **({{}} if isinstance(shape, str) else {{"shape": spec(shape)}}))
    flops = []
    for mesh_shape in ((1, 1), {mesh!r}):
        n = int(np.prod(mesh_shape))
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(mesh_shape),
                    names(mesh_shape))
        with mesh:
            compiled = jax.jit(fn, in_shardings=shardings(mesh)).lower(*args).compile()
        cost = compiled.cost_analysis()
        flops.append((cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"])
    out.append(flops)
print("JSON" + json.dumps(out))
"""


def _run(code: str, src: str, timeout=None, **env) -> object:
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout,
                       env={**os.environ, "PYTHONPATH": src, **env})
    if r.returncode:
        raise RuntimeError(r.stdout[-3000:] + r.stderr[-4000:])
    return json.loads([ln for ln in r.stdout.splitlines()
                       if ln.startswith("JSON")][-1][4:])


def port_flops(arch: str, shape, mesh, *, reduced: bool = False,
               src: str = os.path.join(REPO, "src"), timeout=None) -> list:
    """[FLOPs on (1, 1), rank 0's FLOPs on ``mesh``] of the port's step:
    ``shape`` a shape name or ``(kind, seq, batch)``; the config reduced,
    or at full width and depth 1. One subprocess."""
    return _run(_PORT.format(pkg="_torch", arch=arch, shape=shape,
                             mesh=tuple(mesh), reduced=reduced), src, timeout)


def reference_flops(configs, mesh, *, reduced: bool = False,
                    timeout=None) -> dict:
    """``{(arch, shape): [FLOPs on (1, 1), a device's FLOPs on mesh]}`` of
    the reference's steps (``configs``: (arch, shape) pairs, as
    :func:`port_flops` takes them), compiled by XLA in one subprocess on
    as many forced host devices as ``mesh`` has."""
    n = 1
    for m in mesh:
        n *= m
    configs = [tuple(c) for c in configs]
    flops = _run(_REFERENCE.format(pkg="", configs=configs, mesh=tuple(mesh),
                                   reduced=reduced),
                 os.path.join(REPO, "src"), timeout, JAX_PLATFORMS="cpu",
                 XLA_FLAGS=f"--xla_force_host_platform_device_count={n} "
                 + os.environ.get("XLA_FLAGS", ""))
    return dict(zip(configs, flops))


def share(flops, ranks: int) -> float:
    return flops[1] / flops[0] * ranks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="*",
                    default=[f"{a}:{s}" for a in ARCHS for s in SHAPES])
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh (default 16x16)")
    ap.add_argument("--jobs", type=int, default=5)
    ap.add_argument("--reference", action="store_true",
                    help="also compile the JAX package's steps (needs jax)")
    ap.add_argument("--src", default=os.path.join(REPO, "src"),
                    help="the src directory the port is taken from")
    args = ap.parse_args(argv)
    configs = [tuple(c.split(":")) for c in args.configs]
    mesh = (2, 16, 16) if args.multi_pod else (16, 16)
    ranks = 512 if args.multi_pod else 256

    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        ref = (pool.submit(reference_flops, configs, mesh)
               if args.reference else None)
        port = {(a, s): pool.submit(port_flops, a, s, mesh, src=args.src)
                for a, s in configs}
        port = {k: f.result() for k, f in port.items()}
        ref = ref.result() if ref else {}

    shapes = [s for s in SHAPES if any(s == c[1] for c in configs)]
    print("| arch | " + " | ".join(shapes) + " |")
    print("|" + "---|" * (len(shapes) + 1))
    for arch in [a for a in ARCHS if any(a == c[0] for c in configs)]:
        cells = []
        for s in shapes:
            k = (arch, s)
            cell = f"{share(port[k], ranks):.3g}" if k in port else "-"
            cells.append(cell + (f" ({share(ref[k], ranks):.3g})" if k in ref else ""))
        print(f"| {arch} | " + " | ".join(cells) + " |")


if __name__ == "__main__":
    main()
