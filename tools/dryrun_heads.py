"""What the head split / merge helpers did in dry-run configurations.

  PYTHONPATH=src python tools/dryrun_heads.py ARCH SHAPE [--multi-pod]

Traces the configuration's depth probes as ``repro_torch.launch.dryrun``
does, with ``layers._even_for_view`` (the helpers' one placement choice,
forward and backward) watched, and prints one JSON line: for each choice
the count of mesh dims that took it at full depth (``kept``: already
splitting the heads evenly; ``to_heads``: moved onto the head dim;
``replicated``), the collective bytes a rank the helpers' redistributions
add, and the step's collective bytes a rank, both extrapolated over the
probes as the report's are.
"""
from __future__ import annotations

import argparse
import collections
import json

from repro_torch.launch import dryrun
from repro_torch.launch.shapes import _dryrun_cfg
from repro_torch.models import layers
from repro_torch.sharding import shardwise


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    mesh, mesh_name = dryrun.production_mesh(args.multi_pod)
    cfg = _dryrun_cfg(args.arch)

    seen = collections.defaultdict(collections.Counter)   # tally id -> counts
    choose = layers._even_for_view

    def watched(x, dims, lead):
        recs = shardwise._recorders()
        tally = recs[0].tally if recs else None
        before = sum(tally.coll_bytes.values()) if tally else 0
        y = choose(x, dims, lead)
        if tally is not None:
            counts = seen[id(tally)]
            counts["bytes"] += sum(tally.coll_bytes.values()) - before
            for p, q in zip(x.placements, y.placements):
                if p.is_shard() and (p.dim in dims or p.dim == 1):
                    counts["kept" if p == q else
                           "to_heads" if q.is_shard() else "replicated"] += 1
        return y

    layers._even_for_view = watched
    probes = [(c, p) for c, p in dryrun.depth_probes(cfg) if c]
    dryrun.trace_step(args.arch, args.shape, mesh, probes[0][1])   # warm-up
    seen.clear()
    total = collections.Counter()
    step_bytes = 0
    kept_alive = []                 # so that no later tally takes an id
    for c, p in probes:
        tally = dryrun.trace_step(args.arch, args.shape, mesh, p)
        kept_alive.append(tally)
        for k, v in seen[id(tally)].items():
            total[k] += c * v
        step_bytes += c * sum(tally.coll_bytes.values())
    print(json.dumps({"arch": args.arch, "shape": args.shape, "mesh": mesh_name,
                      **{k: total[k] for k in ("kept", "to_heads", "replicated")},
                      "helper_collective_bytes": total["bytes"],
                      "step_collective_bytes": step_bytes}))


if __name__ == "__main__":
    main()
