"""Hold a dry-run configuration's depth probes to its full-depth trace.

  PYTHONPATH=src python tools/dryrun_probe_check.py ARCH SHAPE [--multi-pod]

Traces the step of ``repro_torch.launch.dryrun`` for (ARCH, SHAPE) on the
16x16 (or, with ``--multi-pod``, the 2x16x16) fake mesh twice: through
its depth probes (``dryrun.probe_step``, what a report holds) and once at
full depth (``dryrun.trace_step``). Prints one JSON line: the seconds of
each, whether the FLOPs, the output bytes and the collectives' counts and
bytes per kind and mesh dim are equal, the ratios probe / full of the
peak of live bytes and of the bytes accessed, and where the collective
counts differ, both.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.launch import dryrun
from repro_torch.launch.shapes import _dryrun_cfg


def _counts(tally):
    return ({f"{k}@{d}": n for (k, d), n in sorted(tally.coll_count.items())},
            {f"{k}@{d}": n for (k, d), n in sorted(tally.coll_bytes.items())})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    mesh, mesh_name = dryrun.production_mesh(args.multi_pod)
    cfg = _dryrun_cfg(args.arch)
    t0 = time.time()
    probe = dryrun.probe_step(args.arch, args.shape, mesh, cfg)
    t1 = time.time()
    full = dryrun.trace_step(args.arch, args.shape, mesh, cfg)
    t2 = time.time()
    (pc, pb), (fc, fb) = _counts(probe), _counts(full)
    line = {"arch": args.arch, "shape": args.shape, "mesh": mesh_name,
            "probe_s": round(t1 - t0, 1), "full_s": round(t2 - t1, 1),
            "flops_equal": probe.flops == full.flops,
            "out_bytes_equal": probe.out_bytes == full.out_bytes,
            "collective_counts_equal": pc == fc,
            "collective_bytes_equal": pb == fb,
            "peak_ratio": probe.peak / full.peak,
            "bytes_ratio": probe.bytes / full.bytes}
    if pc != fc:
        line.update({"probe_counts": pc, "full_counts": fc})
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
