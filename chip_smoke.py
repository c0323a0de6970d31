"""Smoke run of the PyTorch/CUDA port on one GPU: builds the hand-written
kernels from this checkout, holds each against its plain PyTorch version at
the shapes of the paths it drives, drives the main path (STADI on sdxl-dit at
full width) and the guided paths (classifier-free guidance, fused and
interleaved) through ``StadiPipeline.generate``, and checks card-vs-CPU
images.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero):
  1. the card: name and power limit (nvidia-smi), TF32 off for fp32 products
  2. build the CUDA library from src/repro_torch/kernels/csrc
  3. K1 against its plain version on inputs whose scores have a spread of
     2.25 (a peaked softmax, as in a trained model). Bars: fp32 5e-5
     absolute; bf16 1e-3 absolute plus 1e-2 relative (the two bf16
     roundings of the output may differ by one unit in the last place,
     under 2^-7 relative) and a norm-relative error under 2e-3. Each bar
     must also reject planted faults (a 64-key tile skipped, tok_start off
     by one tile). Times of the kernel, the plain version and a library
     attention at the main path's bf16 layouts.
  4. K1 at batch 2, both guidance branches of one layer in one launch, its
     stale K/V a strided view of a branch-stacked [2, L, 1, N, H, hd]
     buffer: the bars and planted faults of phase 3.
  5. K3 (the CFG epilogue) against its plain version at the guided path's
     eps shapes, an odd length and an input one element off alignment, in
     fp32 and bf16: delta and combine bitwise equal. Device times (CUDA
     graph replay) of the kernel, the plain version and the nearest library
     calls (torch.lerp and a torch.sub into fp32), and the wrapper's eager
     time per call, which the host's launch overhead sets.
  6. the main path: sdxl-dit (28 layers, bf16, random nondegenerate weights
     from a seed), 2 logical workers at occupancies [0.0, 0.5], planner
     stadi, backend emulated, exchange sync; finite image, and K1 launched
     once per layer of every forward the trace shows. One more generate
     runs under ``torch.profiler``: its device time by kernel and the
     device idle share are printed.
  7. the guided paths on the same model, cfg_scale 4.0: fused (the main
     path's plan) and interleaved (4 devices at [0.0, 0.0, 0.5, 0.5],
     planner stadi_guidance); finite images, K1 once per layer of every
     guided eval and K3 once per eval whose uncond branch is fresh, both
     derived from the trace; each profiled as in phase 6.
  8. tiny-dit.reduced() in fp32, unguided, fused and interleaved: the card's
     image (through K1 and K3) against the CPU's (through the plain
     versions), relative error < 1e-3
Every path is driven with the launch counters set to 0 just before it and
read just after. The second-to-last line is the kernels' JSON record, the
last line the device record.
"""
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

#: published dense peaks (NVIDIA data sheet, SXM part): bf16 tensor FLOP/s,
#: fp32 (CUDA core) FLOP/s, memory bytes/s
PEAKS = {"H100 80GB HBM3": (989e12, 67e12, 3.35e12)}
SEED = 0
SDXL_CASES = [(4096, 2304, 0), (4096, 1792, 2304), (4096, 4096, 0),
              (4096, 200, 72)]      # two patches, the warm-up, an unaligned layout
QK_STD = 1.5                        # std of q and k: scores of std QK_STD**2
BARS = {torch.float32: dict(atol=5e-5, rtol=0.0),
        torch.bfloat16: dict(atol=1e-3, rtol=1e-2)}
NORM_BARS = {torch.float32: 5e-5, torch.bfloat16: 2e-3}
TILE = 64                           # key rows per tile of the bf16 body
# sdxl-dit's eps per guidance branch: the two patches and the full image
# (the warm-up), and an odd length for the kernel's scalar tail
K3_SHAPES = [(1, 72, 128, 4), (1, 56, 128, 4), (1, 128, 128, 4), (36865,)]
CFG_SCALE = 4.0


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def peaks_for(name):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no published peaks for {name!r}; add them to PEAKS")


def time_ms(fn, reps=10, batches=3):
    """Median over batches of the mean time per call, from CUDA events
    around ``reps`` back-to-back calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def time_graph_ms(fn, reps=100):
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so the host's launch overhead (tens of microseconds a call,
    more than a microsecond kernel takes) stays out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, reps=3) / reps


def k1_bound_ms(B, H, Nl, N, hd, dtype, peaks):
    """Least time for K1's work: operations 4*B*H*Nl*N*hd at the peak of the
    input type, or bytes (q, fresh K/V and the output once, the stale rows
    outside the patch once) at the memory rate, whichever is larger."""
    flops = 4 * B * H * Nl * N * hd
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = elem * B * H * hd * (3 * Nl + 2 * (N - Nl) + Nl)
    ops_ms = flops / (peaks[0] if dtype == torch.bfloat16 else peaks[1]) * 1e3
    bytes_ms = nbytes / peaks[2] * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def k1_inputs(N, Nl, dtype, dev, gen, B=1, H=16, hd=72):
    """q, k_fresh, v_fresh, k_stale, v_stale as [B, S, H, hd]; q and k of
    std QK_STD, so q.k / sqrt(hd) has std QK_STD**2; v of std 1."""
    def mk(n, std):
        return (std * torch.randn(B, n, H, hd, generator=gen)).to(dtype).to(dev)
    return mk(Nl, QK_STD), mk(Nl, QK_STD), mk(Nl, 1.0), mk(N, QK_STD), mk(N, 1.0)


def k1_reading(out, want, dtype):
    """(max absolute error, norm-relative error, within the dtype's bars)"""
    out, want = out.float(), want.float()
    err = (out - want).abs().max().item()
    rel = ((out - want).norm() / want.norm()).item()
    return err, rel, (torch.allclose(out, want, **BARS[dtype])
                      and rel <= NORM_BARS[dtype])


def k1_planted_faults(layers, ref, q, kf, vf, ks, vs, tok):
    """K1's output under planted faults, from plain versions: the first
    fresh tile of keys skipped, the last tile of the context skipped, and
    tok_start off by one tile (where the patch can move)."""
    N, Nl = ks.shape[1], q.shape[1]
    full_k, full_v = ks.clone(), vs.clone()
    full_k[:, tok:tok + Nl] = kf
    full_v[:, tok:tok + Nl] = vf
    faults = {}
    for name, t0 in (("fresh tile skipped", tok), ("last tile skipped", N - TILE)):
        keep = torch.ones(1, 1, 1, N, dtype=torch.bool, device=q.device)
        keep[..., t0:t0 + TILE] = False
        faults[name] = layers.attend(q.float(), full_k.float(), full_v.float(),
                                     mask=keep).to(q.dtype)
    for shift in (TILE, -TILE):
        if 0 <= tok + shift <= N - Nl:
            faults[f"tok_start {shift:+d}"] = ref.stale_kv_attention_ref(
                q, kf, vf, ks, vs, tok + shift)
            break
    return faults


def phase_kernels(ops, ref, layers, dev, peaks):
    """K1 against its plain version on the card, the bars against planted
    faults, and times at the main path's bf16 layouts. Returns the JSON
    record's numbers for the first patch."""
    F = torch.nn.functional
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    B, H, hd = 1, 16, 72
    first = None
    for dtype in (torch.float32, torch.bfloat16):
        for N, Nl, tok in SDXL_CASES:
            q, kf, vf, ks, vs = k1_inputs(N, Nl, dtype, dev, gen, B, H, hd)
            out = ops.stale_kv_attention(q, kf, vf, ks, vs, tok_start=tok)
            want = ref.stale_kv_attention_ref(q, kf, vf, ks, vs, tok)
            err, rel, ok = k1_reading(out, want, dtype)
            faults = {name: k1_reading(out, bad, dtype)
                      for name, bad in k1_planted_faults(
                          layers, ref, q, kf, vf, ks, vs, tok).items()}
            line = {"kernel": "stale_kv_attention", "dtype": str(dtype),
                    "N": N, "Nl": Nl, "tok_start": tok, "max_abs_err": err,
                    "norm_rel_err": rel, "bar": BARS[dtype],
                    "norm_bar": NORM_BARS[dtype], "ok": ok,
                    "planted_faults": {name: {"max_abs_err": e, "norm_rel_err": r,
                                              "rejected": not passed}
                                       for name, (e, r, passed) in faults.items()}}
            if dtype == torch.bfloat16 and Nl % 256 == 0:   # main-path layouts
                ms = time_ms(lambda: ops.stale_kv_attention(
                    q, kf, vf, ks, vs, tok_start=tok))
                plain_ms = time_ms(lambda: ref.stale_kv_attention_ref(
                    q, kf, vf, ks, vs, tok), reps=3)
                full_k, full_v = ks.clone(), vs.clone()
                full_k[:, tok:tok + Nl] = kf
                full_v[:, tok:tok + Nl] = vf
                qt, kt, vt = (t.transpose(1, 2) for t in (q, full_k, full_v))
                library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt))
                bound_ms, bound_by = k1_bound_ms(B, H, Nl, N, hd, dtype, peaks)
                line.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
                if first is None:
                    first = line
            print("k1_check", json.dumps(line), flush=True)
            check(ok, f"K1 disagrees with its plain version: {line}")
            check(all(not passed for _, _, passed in faults.values()),
                  f"the K1 bar lets a planted fault through: {line}")
    return first


def phase_k1_batch2(ops, ref, layers, dev, peaks):
    """K1 over both guidance branches of one layer in one launch, at the
    main path's first patch layout: q/k/v views of a [2, Nl, 3, H, hd]
    projection, the stale K/V the [2, N, H, hd] view of layer 1 of a
    branch-stacked [2, L, 1, N, H, hd] buffer that dit.forward_patch_cfg
    hands over. Returns the bf16 reading."""
    F = torch.nn.functional
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    N, Nl, tok = SDXL_CASES[0]
    B, H, hd, L = 2, 16, 72, 2
    reading = None
    for dtype in (torch.float32, torch.bfloat16):
        def mk(*shape, std=1.0):
            return (std * torch.randn(*shape, generator=gen)).to(dtype).to(dev)
        buf_k, buf_v = mk(2, L, 1, N, H, hd, std=QK_STD), mk(2, L, 1, N, H, hd)
        ks = buf_k.transpose(0, 1).flatten(1, 2)[1]
        vs = buf_v.transpose(0, 1).flatten(1, 2)[1]
        check(ks.data_ptr() == buf_k[0, 1].data_ptr() and not ks.is_contiguous(),
              "the branch-stacked stale K is not read in place")
        qkv = torch.cat([mk(B, Nl, 2, H, hd, std=QK_STD), mk(B, Nl, 1, H, hd)],
                        dim=2)
        q, kf, vf = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = ops.stale_kv_attention(q, kf, vf, ks, vs, tok_start=tok)
        want = ref.stale_kv_attention_ref(q, kf, vf, ks, vs, tok)
        err, rel, ok = k1_reading(out, want, dtype)
        faults = {name: k1_reading(out, bad, dtype)
                  for name, bad in k1_planted_faults(
                      layers, ref, q, kf, vf, ks, vs, tok).items()}
        line = {"kernel": "stale_kv_attention", "batch": B, "dtype": str(dtype),
                "N": N, "Nl": Nl, "tok_start": tok, "max_abs_err": err,
                "norm_rel_err": rel, "ok": ok,
                "planted_faults": {name: {"norm_rel_err": r, "rejected": not passed}
                                   for name, (_, r, passed) in faults.items()}}
        if dtype == torch.bfloat16:
            full_k, full_v = ks.clone(), vs.clone()
            full_k[:, tok:tok + Nl] = kf
            full_v[:, tok:tok + Nl] = vf
            qt, kt, vt = (t.transpose(1, 2) for t in (q, full_k, full_v))
            bound_ms, bound_by = k1_bound_ms(B, H, Nl, N, hd, dtype, peaks)
            line.update(
                ms=time_ms(lambda: ops.stale_kv_attention(q, kf, vf, ks, vs,
                                                          tok_start=tok)),
                plain_ms=time_ms(lambda: ref.stale_kv_attention_ref(
                    q, kf, vf, ks, vs, tok), reps=3),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt)),
                bound_ms=bound_ms, bound_by=bound_by)
            reading = line
        print("k1_batch2_check", json.dumps(line), flush=True)
        check(ok, f"K1 at batch 2 disagrees with its plain version: {line}")
        check(all(not passed for _, _, passed in faults.values()),
              f"the K1 bar lets a planted fault through at batch 2: {line}")
    return reading


def k3_bound_ms(n, dtype, peaks):
    """Least time for K3's work: eps_c and eps_u read once, the combine (eps
    dtype) and the fp32 delta written once, at the memory rate; or three
    fp32 operations an element at the CUDA-core peak."""
    elem = torch.tensor([], dtype=dtype).element_size()
    bytes_ms = n * (3 * elem + 4) / peaks[2] * 1e3
    ops_ms = 3 * n / peaks[1] * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def phase_k3(ops, ref, dev, peaks):
    """K3 bitwise against its plain version; times at the main path's bf16
    shapes. Returns the reading at the first patch's shape."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    first = None
    for dtype in (torch.float32, torch.bfloat16):
        for shape in K3_SHAPES:
            n = math.prod(shape)
            for offset in (0, 1):
                ec, eu = (torch.randn(n + offset, generator=gen).to(dtype).to(dev)
                          [offset:].view(shape) for _ in range(2))
                comb, delta = ops.cfg_epilogue(ec, eu, CFG_SCALE)
                want_comb, want_delta = ref.cfg_epilogue_ref(ec, eu, CFG_SCALE)
                err = (comb.float() - want_comb.float()).abs().max().item()
                line = {"kernel": "cfg_epilogue", "dtype": str(dtype),
                        "shape": list(shape), "offset": offset,
                        "max_abs_err": err,
                        "delta_max_abs_err": (delta - want_delta).abs().max().item(),
                        "bitwise": bool(torch.equal(comb, want_comb)
                                        and torch.equal(delta, want_delta))}
                if dtype == torch.bfloat16 and offset == 0 and len(shape) == 4:
                    d32 = torch.empty(shape, dtype=torch.float32, device=dev)

                    def library():
                        torch.lerp(eu, ec, CFG_SCALE)
                        torch.sub(ec, eu, out=d32)
                    bound_ms, bound_by = k3_bound_ms(n, dtype, peaks)
                    kernel = lambda: ops.cfg_epilogue(ec, eu, CFG_SCALE)
                    line.update(
                        ms=time_graph_ms(kernel),
                        plain_ms=time_graph_ms(lambda: ref.cfg_epilogue_ref(
                            ec, eu, CFG_SCALE)),
                        library_ms=time_graph_ms(library),
                        eager_ms=time_ms(kernel, reps=100),
                        bound_ms=bound_ms, bound_by=bound_by)
                    if first is None:
                        first = line
                print("k3_check", json.dumps(line), flush=True)
                check(line["bitwise"],
                      f"K3 is not bitwise equal to its plain version: {line}")
    return first


def _expected_launches(result, n_layers):
    """Launches a generate must make, from its trace: K1 once per layer of
    every denoiser eval (one full-image eval per warm-up step, one patch
    eval per substep; a guided eval runs both branches in one launch), and
    on a guided run K3 once per eval whose uncond branch is computed
    (interleaved reuse evals run the cond branch alone and apply the
    cached delta instead)."""
    trace = result.trace
    evals = fresh = 0
    for e in trace.events:
        subs = [1] if e.synchronous else e.substeps
        evals += sum(subs)
        fresh += sum(s for i, s in enumerate(subs)
                     if e.synchronous or e.uncond_fresh
                     or not trace.guidance.worker_reuses(i))
    expected = {"stale_kv_attention": n_layers * evals}
    if trace.guidance is not None:
        expected["cfg_epilogue"] = fresh
    return expected


def profile_generate(pipe, x_T, cond, wall_s, label, top=12):
    """One generate under torch.profiler: device time by kernel and the
    device idle share (1 - busy / the unprofiled wall time: the profiler
    slows the host, not the kernels)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.generate(x_T, cond)
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((ev.key, dev_us, ev.count))
    kernels.sort(key=lambda k: -k[1])
    busy_s = sum(us for _, us, _ in kernels) * 1e-6
    k1_s = sum(us for name, us, _ in kernels if "stale_kv_attention" in name) * 1e-6
    k3_s = sum(us for name, us, _ in kernels if "cfg_epilogue" in name) * 1e-6
    print(f"{label}_profile", json.dumps({
        "wall_s": wall_s, "device_busy_s": busy_s,
        "device_idle_share": max(0.0, 1.0 - busy_s / wall_s),
        "k1_device_s": k1_s, "k1_share_of_busy": k1_s / busy_s if busy_s else None,
        "k3_device_s": k3_s, "k3_share_of_busy": k3_s / busy_s if busy_s else None,
        "top_kernels": [{"name": n[:120], "device_s": us * 1e-6, "calls": c}
                        for n, us, c in kernels[:top]]}), flush=True)


def drive_path(ops, label, cfg, params, config, dev):
    """Drive one path through ``StadiPipeline.generate`` on sdxl-dit: a
    warm-up call, then a generate with the launch counters set to 0 just
    before it and read just after, checked against the trace, then one
    more under the profiler. Returns the launches."""
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiPipeline

    sched = sampler.linear_schedule(1000)
    pipe = StadiPipeline(cfg, params, sched, config, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x_T = torch.randn(1, cfg.latent_size, cfg.latent_size, cfg.channels,
                      generator=gen, device=dev).to(torch.bfloat16)
    cond = torch.tensor([SEED % cfg.n_classes], device=dev)
    plan = pipe.plan()
    print(f"{label} plan: planner={plan.planner} steps={plan.temporal.steps} "
          f"ratios={plan.temporal.ratios} patches={plan.patches} "
          f"guidance={plan.guidance} (K1 at Nl="
          f"{[p * cfg.tokens_per_side for p in plan.patches]} of "
          f"N={cfg.n_tokens}) T={sched.T}", flush=True)
    t0 = time.perf_counter()
    pipe.generate(x_T, cond)                   # first call: cuBLAS warm-up
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe.generate(x_T, cond)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    img = res.image
    expected = _expected_launches(res, cfg.n_layers)
    print(f"{label} sdxl-dit generate: {seconds:.3f} s (first call "
          f"{first_s:.3f} s), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, image "
          f"{tuple(img.shape)} {img.dtype}, launches {launches}, expected "
          f"launches {expected}, kernel_stats {res.kernel_stats}", flush=True)
    check(tuple(img.shape) == (1, cfg.latent_size, cfg.latent_size, cfg.channels),
          f"{label}: image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img.float()).all()), f"{label}: non-finite image")
    check(launches == expected and all(expected.values()),
          f"{label}: launches {launches}, the trace needs {expected}")
    check(res.kernel_stats == {"launches": launches},
          f"{label}: kernel_stats mismatch")
    profile_generate(pipe, x_T, cond, seconds, label)
    return launches


def phase_paths(ops, dev):
    """The main path and the two guided paths on one set of sdxl-dit
    weights. Returns {label: launches}."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import StadiConfig
    from repro_torch.models.diffusion import dit

    cfg = get_config("sdxl-dit")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = dit.nondegenerate_params(dit.init_params(gen, cfg), gen)
    main = StadiConfig.from_occupancies([0.0, 0.5], m_base=16, m_warmup=4,
                                        planner="stadi", backend="emulated",
                                        exchange="sync")
    paths = {
        "main_path": main,
        "guided_fused": dataclasses.replace(main, cfg_scale=CFG_SCALE),
        "guided_interleaved": StadiConfig.from_occupancies(
            [0.0, 0.0, 0.5, 0.5], m_base=16, m_warmup=4, cfg_scale=CFG_SCALE,
            planner="stadi_guidance", guidance="interleaved"),
    }
    return {label: drive_path(ops, label, cfg, params, config, dev)
            for label, config in paths.items()}


def phase_cross_device(dev):
    """tiny-dit.reduced() in fp32 on the card and on the CPU: unguided,
    guided fused and guided interleaved."""
    from repro_torch.configs import get_config
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiConfig, StadiPipeline
    from repro_torch.models.diffusion import dit

    cfg = get_config("tiny-dit").reduced()
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    params = dit.nondegenerate_params(dit.init_params(gen, cfg), gen)
    x_T = torch.randn(2, cfg.latent_size, cfg.latent_size, cfg.channels,
                      generator=gen)
    cond = torch.tensor([1, 2])
    configs = {
        "unguided": StadiConfig.from_occupancies([0.0, 0.5], m_base=8,
                                                 m_warmup=2),
        "guided_fused": StadiConfig.from_occupancies(
            [0.0, 0.5], m_base=8, m_warmup=2, cfg_scale=CFG_SCALE),
        "guided_interleaved": StadiConfig.from_occupancies(
            [0.0, 0.0, 0.5, 0.5], m_base=16, m_warmup=4, cfg_scale=CFG_SCALE,
            planner="stadi_guidance", guidance="interleaved"),
    }
    rels = {}
    for label, config in configs.items():
        images = {d: StadiPipeline(cfg, params, sampler.linear_schedule(1000),
                                   config, device=d).generate(x_T, cond).image.cpu()
                  for d in ("cpu", dev)}
        rel = ((images[dev] - images["cpu"]).norm() / images["cpu"].norm()).item()
        print(f"cross_device tiny-dit.reduced fp32 {label}: card vs CPU "
              f"relative error {rel:.3e} (bar 1e-3)", flush=True)
        check(rel < 1e-3, f"{label}: card image differs from the CPU image: {rel}")
        rels[label] = rel
    return rels


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    from repro_torch.kernels import ops, ref     # fails outside a checkout
    from repro_torch.models import layers

    dev = "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device {name}, torch {torch.__version__}, CUDA {torch.version.cuda}; "
          "TF32 off for fp32 matmul and cuDNN", flush=True)
    peaks = peaks_for(name)

    lib = ops.load_library()
    print(f"build: {lib.path.name} in {lib.build_seconds:.1f} s", flush=True)
    k1 = phase_kernels(ops, ref, layers, dev, peaks)
    k1_b2 = phase_k1_batch2(ops, ref, layers, dev, peaks)
    k3 = phase_k3(ops, ref, dev, peaks)
    launches = phase_paths(ops, dev)
    phase_cross_device(dev)

    def entry(name, source, replaces, reading, main_label):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[main_label][name],
                "max_abs_err": reading["max_abs_err"], "ms": reading["ms"],
                "plain_ms": reading["plain_ms"], "bound_ms": reading["bound_ms"],
                "bound_by": reading["bound_by"],
                "library_ms": reading["library_ms"],
                "launches_by_path": {label: n.get(name, 0)
                                     for label, n in launches.items()}}
    record = {"kernels": [
        {**entry("stale_kv_attention",
                 "src/repro_torch/kernels/csrc/stale_kv_attention.cu",
                 "src/repro/kernels/stale_kv_attention.py:69", k1, "main_path"),
         "batch2_ms": k1_b2["ms"], "batch2_bound_ms": k1_b2["bound_ms"]},
        {**entry("cfg_epilogue", "src/repro_torch/kernels/csrc/cfg_epilogue.cu",
                 "src/repro/kernels/cfg_epilogue.py:34", k3, "guided_fused"),
         "eager_ms": k3["eager_ms"]},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
