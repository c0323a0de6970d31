"""Batched LLM serving with the port's serving engine, any ``--arch``
(reference: ``examples/serve_llm.py``). Runs on the GPU unless
``--device cpu`` is given.

  PYTHONPATH=src python examples/serve_llm_torch.py --arch gemma-2b --requests 6
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    done = serve(args.arch, n_requests=args.requests, slots=3,
                 prompt_len=12, max_new=8, device=args.device)
    for r in done[:3]:
        print(f"req {r.uid}: prompt {r.prompt[:6].tolist()}... -> "
              f"{r.out_tokens}")
    return done


if __name__ == "__main__":
    main()
