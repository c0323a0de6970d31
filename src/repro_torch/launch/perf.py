"""Perf variants of one (arch x shape) dry-run (reference:
``repro.launch.perf``): trace the step under named optimization variants
and re-derive the roofline terms.

Variants (composable, comma-separated), each with the reference's meaning:
  chunked        attn_impl=chunked (attn_chunk 2048): flash-style attention,
                 priced without the materialized S x T scores (the port runs
                 kernel K6 under either attn_impl)
  seqpar         shard the sequence dim (dim 1) of the step's second input
                 tree over 'model' where it is unsharded: the batch for
                 train and prefill (sequence parallelism), the cache for
                 decode (the reference's index)
  embed_dp       embedding/vocab tables: vocab x 'model' -> d_model-only
                 ('data'), trading the logits' gathers for replicated vocab
  cache_nosplit  KV caches batch-sharded only (no T-over-model fallback),
                 other cache leaves replicated
  actbatch       residual stream redistributed to batch over 'data' at each
                 block (cfg.act_shard="batch"; layers.constrain_residual)
  actseq         ... and sequence over 'model' (cfg.act_shard="seqpar")

The reference's docstring also names ``remat``, which its code does not
implement; it is not ported. The reference mutates ``specs._RULES`` and
``specs.cache_specs`` and restores them; here the overrides are passed to
``shapes.build_lowerable`` and give the same specs.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch gemma-2b \\
      --shape decode_32k --variants cache_nosplit,embed_dp
"""
from __future__ import annotations

import argparse
import json
import os
import time

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "perf_torch")
VARIANTS = ("chunked", "seqpar", "embed_dp", "cache_nosplit", "actbatch",
            "actseq")


def variant_overrides(arch: str, shape_name: str, vset, cfg):
    """(cfg, build_lowerable's keyword overrides) of the variant set."""
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.sharding import specs as sh

    unknown = set(vset) - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown variants {sorted(unknown)}; known {VARIANTS}")
    if "chunked" in vset:
        cfg = cfg.replace(attn_impl="chunked", attn_chunk=2048)
    if "actbatch" in vset:
        cfg = cfg.replace(act_shard="batch")
    if "actseq" in vset:
        cfg = cfg.replace(act_shard="seqpar")
    kw = {}
    if "embed_dp" in vset:
        kw["rules"] = {**sh._RULES, "embed": (None, "data"), "head": ("data", None)}
    if "cache_nosplit" in vset:
        kw["cache_split"] = False
    if "seqpar" in vset:
        idx = 2 if SHAPES[shape_name].kind == "train" else 1

        def reseq(spec):
            if isinstance(spec, dict):
                return {k: reseq(v) for k, v in spec.items()}
            if isinstance(spec, list):
                return [reseq(v) for v in spec]
            if len(spec) >= 2 and spec[1] is None:
                return (spec[0], "model") + tuple(spec[2:])
            return spec

        kw["respec"] = lambda specs: tuple(reseq(s) if i == idx else s
                                           for i, s in enumerate(specs))
    return cfg, kw


def run_variant(arch: str, shape_name: str, variants: str,
                multi_pod: bool = False) -> dict:
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import _dryrun_cfg

    vset = set(v for v in variants.split(",") if v)
    cfg, kw = variant_overrides(arch, shape_name, vset, _dryrun_cfg(arch))
    mesh, mesh_name = dryrun.production_mesh(multi_pod)
    t0 = time.time()
    rep = dryrun.make_report(arch, shape_name, mesh, mesh_name, cfg,
                             flash="chunked" in vset, verbose=False, **kw)
    roof = rep["roofline"]
    report = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "variants": sorted(vset) or ["baseline"],
        "compile_s": round(time.time() - t0, 1),
        "temp_bytes_per_dev": rep["memory_analysis"]["temp_size_in_bytes"],
        "collective_bytes": rep["collective_bytes"],
        "roofline": roof,
    }
    os.makedirs(RESULTS_DIR, exist_ok=True)
    tag = "-".join(sorted(vset)) or "baseline"
    out = os.path.join(RESULTS_DIR, f"{arch}__{shape_name}__{tag}.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"[{arch} x {shape_name} | {tag}] compute={roof['compute_s']:.4g}s "
          f"memory={roof['memory_s']:.4g}s collective={roof['collective_s']:.4g}s "
          f"dom={roof['dominant']} (trace {report['compile_s']}s)", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", default="")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    run_variant(args.arch, args.shape, args.variants, args.multi_pod)


if __name__ == "__main__":
    main()
