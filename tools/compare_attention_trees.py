"""Time the kernels (K1 to K7) and the Hymba serving path of two checkouts
on one card, in turns: each checkout's own ``chip_smoke.py`` phases
(``phase_kernels``, ``phase_k1_batch2``, ``phase_k3``, ``phase_k2``,
``phase_k5``, ``phase_k4``, ``phase_k6``, ``phase_k7``: checks, planted
faults and times; ``phase_hymba``: Hymba-1.5B served at full width, its time
to first token and decode time per token; ``phase_paths``, on request: the
sdxl-dit main and guided generates, their wall and device-busy seconds) run
in a process of their own,
which builds that checkout's CUDA library from its sources;
then the host time of one K1, K4 and K7 (S 1) wrapper call at their path
shapes, with the parts of K7's, and the registers and spills ptxas reports
for each kernel of the build.

    python3 tools/compare_attention_trees.py OTHER_CHECKOUT [THIS_CHECKOUT]
        [--order ABBA] [--phases phase_k6,phase_k7] [--log-dir build/compare]

A is OTHER_CHECKOUT (say a ``git archive`` of the parent commit unpacked in
a git-ignored directory), B this checkout (the default) or the one given.
The default order A, B, B, A puts each version first once. Each turn's
whole output goes to ``<log-dir>/compare_<turn>_<A|B>.log``; the summary
prints, per turn, every timed line's kernel, layout and milliseconds, and
one JSON line with all of them. A phase whose check fails is reported and
the turn goes on to the next phase. Needs a CUDA card; exits non-zero if a
turn fails.
"""
import argparse
import json
import os
import subprocess
import sys

PHASES = ("phase_kernels", "phase_k1_batch2", "phase_k3", "phase_k2",
          "phase_k5", "phase_k4", "phase_k6", "phase_k7", "phase_hymba")
PATH_PROFILES = ("main_path_profile", "guided_fused_profile",
                 "guided_interleaved_profile")
LABELS = ("k1_check", "k1_batch2_check", "k3_check", "k2_check", "k5_check",
          "k4_check", "k6_check", "k7_check", "hymba_serve", "host_check",
          "ptxas_check") + PATH_PROFILES
LAYOUT_KEYS = ("batch", "N", "Nl", "tok_start", "valid_tokens",
               "uncond_fresh", "valid_len", "dtype", "shape", "G",
               "with_delta", "causal", "window", "prefix_len", "S", "h0",
               "function")
TIME_KEYS = ("ms", "floor_ms", "plain_ms", "library_ms", "bound_ms", "eager_ms",
             "wall_s", "device_busy_s", "device_idle_share",
             "wrapper_host_us", "parts_us", "max_abs_err", "norm_rel_err",
             "ttft_ms", "decode_ms_per_token", "tokens_per_s", "registers",
             "spill_stores", "spill_loads")

# Run in the child: load the checkout's chip_smoke.py as a module (its main
# is not run) with the checkout's src/ first on the path, then its phases.
CHILD = r"""
import importlib.util, os, re, sys, torch
root = sys.argv[1]
sys.path.insert(0, os.path.join(root, "src"))
spec = importlib.util.spec_from_file_location("tree_smoke", os.path.join(root, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from repro_torch.kernels import ops, ref
from repro_torch.models import layers
assert os.path.dirname(os.path.abspath(ops.__file__)).startswith(os.path.abspath(root))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
peaks = smoke.peaks_for(torch.cuda.get_device_name(0))
lib = ops.load_library()
print(f"build: {lib.path} in {lib.build_seconds:.1f} s", flush=True)
import json, time
# registers and spills of every kernel entry ptxas compiled in this build
entry = None
for line in lib.ptxas_log.splitlines():
    m = re.search(r"Compiling entry function '(\w+)'", line)
    if m:
        entry = m.group(1)
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
    if m and entry:
        spills = (int(m.group(1)), int(m.group(2)))
    m = re.search(r"Used (\d+) registers", line)
    if m and entry:
        print("ptxas_check", json.dumps({"function": entry, "registers": int(m.group(1)),
              "spill_stores": spills[0], "spill_loads": spills[1]}), flush=True)
        entry = None
failed = []
for name in sys.argv[2:]:
    fn = getattr(smoke, name)
    if name in ("phase_kernels", "phase_k1_batch2"):
        args = (ops, ref, layers, "cuda", peaks)
    elif name in ("phase_hymba", "phase_paths"):
        args = (ops, "cuda")
    else:
        args = (ops, ref, "cuda", peaks)
    try:
        fn(*args)
    except RuntimeError as err:  # a failed check: report it, go on to the next phase
        print(f"{name} failed: {err}", flush=True)
        failed.append(name)
# host time of one wrapper call (enqueue only; the card runs behind), the
# same public calls in either checkout
def host_us(fn, reps=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us
gen = torch.Generator(device="cpu").manual_seed(smoke.SEED)
q, kf, vf, ks, vs = smoke.k1_inputs(4096, 2304, torch.bfloat16, "cuda", gen)
print("host_check", json.dumps({"kernel": "stale_kv_attention", "Nl": 2304, "wrapper_host_us":
      host_us(lambda: ops.stale_kv_attention(q, kf, vf, ks, vs, tok_start=0))}), flush=True)
q4, k4, v4 = smoke.k4_inputs(torch.bfloat16, "cuda", gen)
print("host_check", json.dumps({"kernel": "lse_attention", "valid_len": 3200, "wrapper_host_us":
      host_us(lambda: ops.lse_attention(q4, k4, v4, 3200))}), flush=True)
# K7 at decode (S 1, h0 and the final state, as mamba_forward calls it), and
# the parts of a call that a wrapper may spend host time on
x, dt, b, c, a, d, h0 = smoke.k7_inputs(1, "cuda", gen)
dev = x.device
def device_context():
    with torch.cuda.device(dev):
        pass
parts = {
    "checks_and_launch": host_us(lambda: ops.ssm_scan(x, dt, b, c, a, d, h0=h0,
                                                      final_state=True)),
    "torch.cuda.device": host_us(device_context),
    "current_stream": host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
    "current_device": host_us(torch.cuda.current_device),
    "two_empty": host_us(lambda: (torch.empty(x.shape, device=dev),
                                  torch.empty((1, 1600, 16), device=dev))),
    "ctypes_int64_array": host_us(lambda: (__import__("ctypes").c_int64 * 10)(*range(10))),
    "data_ptr_x9": host_us(lambda: [t.data_ptr() for t in (x, dt, b, c, a, d, h0, x, dt)]),
}
print("host_check", json.dumps({"kernel": "ssm_scan", "S": 1, "wrapper_host_us":
      parts["checks_and_launch"], "parts_us": parts}), flush=True)
sys.exit(1 if failed else 0)
"""


def timed_lines(log):
    """The JSON readings of the timed lines of one turn's output."""
    out = []
    for line in log.splitlines():
        label, _, rest = line.partition(" ")
        if label in LABELS and rest.startswith("{"):
            reading = json.loads(rest)
            if "ms" in reading or label in ("host_check", "hymba_serve",
                                            "ptxas_check") + PATH_PROFILES:
                out.append({"label": label,
                             **{k: reading[k] for k in LAYOUT_KEYS + TIME_KEYS
                                if k in reading}})
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("this", nargs="?",
                    default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated chip_smoke phases to run per turn")
    ap.add_argument("--log-dir", default="build/compare")
    args = ap.parse_args()
    trees = {"A": os.path.abspath(args.other), "B": os.path.abspath(args.this)}
    os.makedirs(args.log_dir, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    summary, failed = [], []
    for turn, key in enumerate(args.order):
        proc = subprocess.run([sys.executable, "-c", CHILD, trees[key],
                               *args.phases.split(",")],
                              capture_output=True, text=True, timeout=1200)
        log = proc.stdout + proc.stderr
        path = os.path.join(args.log_dir, f"compare_{turn}_{key}.log")
        with open(path, "w") as f:
            f.write(log)
        lines = timed_lines(proc.stdout)
        summary.append({"turn": turn, "tree": key, "path": trees[key],
                        "rc": proc.returncode, "timed": lines})
        print(f"turn {turn} {key} ({trees[key]}): rc {proc.returncode}, log {path}",
              flush=True)
        for line in lines:
            layout = " ".join(f"{k}={line[k]}" for k in LAYOUT_KEYS if k in line)
            if "ms" in line:
                library = line.get("library_ms")
                print(f"  {line['label']:16s} {layout:48s} {line['ms']:.4f} ms"
                      f" (library {float('nan') if library is None else library:.4f},"
                      f" bound {line.get('bound_ms', float('nan')):.4f})", flush=True)
            elif line["label"] == "hymba_serve":
                print(f"  {line['label']:16s} TTFT {line['ttft_ms']} ms, decode "
                      f"{line['decode_ms_per_token']:.2f} ms/token, "
                      f"{line['tokens_per_s']:.2f} tokens/s", flush=True)
            elif line["label"] in PATH_PROFILES:
                print(f"  {line['label']:16s} generate {line['wall_s']:.3f} s, device "
                      f"busy {line['device_busy_s']:.3f} s", flush=True)
            elif line["label"] == "ptxas_check":
                print(f"  {line['label']:16s} {layout:48s} {line['registers']} registers,"
                      f" spills {line['spill_stores']}/{line['spill_loads']} B", flush=True)
            else:
                print(f"  {line['label']:16s} {layout:48s} wrapper "
                      f"{line['wrapper_host_us']:.1f} us on the host", flush=True)
        if proc.returncode:
            failed.append(turn)
            print(log[-3000:], flush=True)
    print(json.dumps({"device": smi, "turns": summary}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
