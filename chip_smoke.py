"""Smoke run of the PyTorch/CUDA port on one GPU: builds the hand-written
kernels from this checkout, holds each against its plain PyTorch version at
the shapes of the paths it drives, drives the LLM serving path (Hymba-1.5B
at full width through the ServingEngine), the diffusion serving path
(sdxl-dit through the DiffusionServingEngine's emulated lanes), the main
path (STADI on sdxl-dit at full width), the guided paths (classifier-free guidance, fused and
interleaved) through ``StadiPipeline.generate`` and the multi-rank paths
(spmd, unguided, fused and split guidance, and spmd_seq, sequence-parallel
attention) on gloo ranks that share the card, the displaced stage chain
(pipefuse, its serving lanes and spmd_pipefuse), the multi-rank serving
lanes (the spmd stepper), the frame axis (4-frame videos: emulated,
guided, the stadi_video plan, spmd_frames and the video serving lanes) and
prompt conditioning (the frozen text encoder and the DiT's prompt
cross-attention: the main path, guided, a guided video, the prompt-bucket
serving lanes and spmd on a prompt), and checks card-vs-CPU outputs.

    python3 chip_smoke.py
    python3 chip_smoke.py --nccl     # only phases 11, 19 and 22, over NCCL

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
     attention at the main path's bf16 layouts, and the wrapper's host time
     per call (phases 4, 6, 7 and 8 too).
  4. K1 at batch 2, both guidance branches of one layer in one launch, its
     stale K/V a strided view of a branch-stacked [2, L, 1, N, H, hd]
     buffer: the bars and planted faults of phase 3.
  5. K3 (the CFG epilogue) against its plain version: one scalar scale at
     the guided path's eps shapes and an odd length, and a vector of
     per-lane scales over lane groups of G = 1, 2 and 4 (the serving
     engine's guided dispatches: patch [G, 72, 128, 4], warm-up
     [G, 128, 128, 4], a lane of 105 elements), each also one element off
     alignment, in fp32 and bf16: delta and combine bitwise equal, and the
     planted fault of lane 0's scale used for every lane rejected. Device
     times (CUDA graph replay) at the bf16 serving shapes, with and without
     delta, of the kernel, an empty kernel (the card's launch floor), the
     plain version and the nearest library calls (torch.lerp with a
     [G, 1, 1, 1] weight and a torch.sub into fp32), and the wrapper's eager
     time per call, which the host's launch overhead sets.
  6. K2 (the padded multi-rank form of K1) against its plain version at the
     spmd main path's rank layouts (slab 2304 rows, tok_start 0 / valid
     2304 and tok_start 2304 / valid 1792, buffer 6400 rows of which 4096
     real) and at tok_start 0 / valid 1792, batch 1 and 2, fp32 and bf16,
     inputs random everywhere (scratch included), with K1's bars. Each bar
     must reject three planted faults wherever they change the function:
     valid_tokens ignored, the scratch key mask dropped, tok_start one
     64-key tile off. Times of the kernel, the plain version and
     scaled_dot_product_attention on the materialized, masked K/V.
  7. K5 (K2 over both guidance branches) with uncond_fresh 0 and 1: the
     bars and faults of phase 6.
  8. K4 (one ring segment of spmd_seq with its fp32 LSE) against its plain
     version at the spmd_seq path's hop shapes (q [1, 4608, 8, 72], k/v the
     strided second head group of a [1, 3200, 16, 72] segment, valid_len
     3200 and 896), at valid_len 0 (an empty segment: out 0, lse -1e30)
     and at an unaligned 1001, fp32 and bf16, with K1's bars on out and
     lse. Each bar must reject three planted faults: valid_len ignored, the
     segment shifted by one 64-key tile, the LSE without its log l term.
     Times of the kernel, the plain version and scaled_dot_product_attention
     over k[:, :valid_len] (unmasked; it returns no LSE).
  9. the main path: sdxl-dit (28 layers, bf16, random nondegenerate weights
     from a seed), 2 logical workers at occupancies [0.0, 0.5], planner
     stadi, backend emulated, exchange sync; finite image, and K1 launched
     once per layer of every forward the trace shows. One more generate
     runs under ``torch.profiler``: its device time by kernel and the
     device idle share are printed.
  10. the guided paths on the same model, cfg_scale 4.0: fused (the main
     path's plan) and interleaved (4 devices at [0.0, 0.0, 0.5, 0.5],
     planner stadi_guidance); finite images, K1 once per layer of every
     guided eval and K3 once per eval whose uncond branch is fresh, both
     derived from the trace; each profiled as in phase 8.
 11. the multi-rank paths on gloo ranks sharing the card (gloo passes the
     CUDA tensors through host memory): sdxl-dit backend spmd on 2 ranks
     (the main path's cluster), unguided and fused guided, backend
     spmd_guidance on 4 ranks at [0.0, 0.0, 0.5, 0.5] (split), and backend
     spmd_seq on 2 x 2 ranks (the main path's cluster, seq_shards 2,
     exchange ring; timed on its one generate, its collectives timed
     between card synchronisations), and backend spmd on 2 ranks with the
     text-conditioned model on PROMPT (``spmd_prompt_check``); each rank's
     K1, K2, K3 and K4
     launches equal to its trace's count, finite images equal on every
     rank, relative error against the emulated image on the card < 1e-2
     (bf16, 16 steps). tiny-dit.reduced() fp32 through the same backends
     (sync, stale_async, fused, split, spmd_seq) against the emulated image
     on the CPU, < 1e-3. Per-rank seconds are printed; ranks that share a
     card take turns on it, so they are not a multi-GPU makespan.
 12. tiny-dit.reduced() in fp32, unguided, fused and interleaved: the card's
     image (through K1 and K3) against the CPU's (through the plain
     versions), relative error < 1e-3; the same for
     tiny-dit.reduced().text_conditioned(8) on two prompts, unguided and
     fused, after the frozen tower (card vs CPU max abs error < 1e-4)
 13. K6 (causal / sliding-window flash attention with GQA and a meta-token
     prefix) against its plain version at Hymba-1.5B's prefill shapes (q
     [1, 2048, 25, 64], k/v [1, 2048, 5, 64]) for causal only, causal +
     window 1024, and window 1024 + prefix 128, fp32 and bf16, with K1's
     bars; each bar must reject three planted faults (the prefix ignored,
     the window one key wider, KV head h % K). Times of the kernel, the
     plain version and scaled_dot_product_attention (enable_gqa; is_causal
     or the boolean mask).
 14. K7 (the selective scan) against its plain version at Hymba's Mamba
     shapes (x/dt [1, 2048, 1600] and [1, 1, 1600], N 16, fp32), from zero
     and from a nonzero h0, 5e-5 on y and the final state; each bar must
     reject five planted faults (h0 ignored, the state reset at a 64-step
     tile, the D x skip dropped, and at the scan body's first 128-step
     chunk boundary the carry dropped or entering without its decay).
     Times of the kernel and the plain version (no PyTorch call computes a
     scan); at S 1 device times by CUDA-graph replay and the wrapper's
     eager time per call.
 15. the LLM serving path: Hymba-1.5B at full width in bf16 (random weights
     from a seed), 4 requests of 1920 tokens on 4 slots, 16 new tokens each
     (128 meta + 1920 positions, past the 1152-slot ring): tokens in range,
     two runs with the same tokens, K6 32 and K7 32 x 16 launches per
     request; time to first token, decode ms per token, tokens per second
     (the ``hymba_serve`` line), and the first request served alone, timed
     and then profiled (``hymba_serve_profile``).
     Then hymba-1.5b.reduced() fp32 with GQA 4/2, card against CPU: logits
     within 1e-4 relative, the same tokens.
 16. the diffusion serving path: sdxl-dit at full width in bf16 on the main
     path's emulated plan, 6 requests on 4 slots through
     DiffusionServingEngine (SERVE_TRAFFIC: two guided requests at round
     0, four more after round 2, two of them unguided, scales 3.0 and 5.0),
     exchange sync, after a warm-up drain: K1 once a layer of every
     denoiser dispatch and K3 once per guided dispatch (never once a lane),
     both from the engine's own dispatch count; every image within 1e-2
     relative of a lone generate of its request; per-request wall and
     modeled latency, images per second (the ``diffusion_serve`` line), one
     mixed round profiled (``diffusion_serve_profile``). Then
     tiny-dit.reduced() fp32 served on the card against the CPU, < 1e-3.
 17. the lane batches of this slice's serving steppers: K1 over G lanes
     (G 2 from slot 1, G 4), its stale K/V the slot-range view of one
     layer of the [L, 4, N, H, hd] displaced contexts, and K2 over a cohort
     of 4 lanes at the spmd path's rank layouts, fp32 and bf16, with the
     bars and planted faults of phases 3 and 6, timed at bf16.
 18. the displaced stage chain, backend pipefuse, on the main path's model
     and plan: at one stage the image bitwise the emulated one; at two
     stages unguided and guided fused (cfg_scale 4.0, K3 with its delta
     once a guided eval, at phase 5's eps shapes), each driven as in
     phase 9 (launches from the trace), its relative difference from the
     emulated image (above 0, below 1e-2) and its seconds beside the
     emulated generate's printed (``pipefuse_check``), the unguided one
     profiled; the guided chain within a tenth of that difference of the
     same chain on K3's plain version. Then the pipefuse serving lanes at
     two stages: SERVE_TRAFFIC's six requests, all unguided, on 4 slots
     (``diffusion_serve_pipefuse``: K1 = 28 x dispatches, each image
     bitwise its lone pipefuse generate, drain seconds and images per
     second).
 19. two ranks (gloo sharing the card; NCCL a card each under --nccl):
     spmd_pipefuse at two stages (ranks = stages; per rank K1 28 per
     warm-up step plus its stage's blocks per micro-task, image bitwise
     the emulated pipefuse image, peak memory per rank, and the handoff
     and broadcast seconds per rank from one more generate under the
     collectives wrapper, ``spmd_pipefuse_check``), then the spmd serving
     lanes on the six unguided requests (``diffusion_serve_spmd``: per
     rank K1 28 x warm-up dispatches, K2 28 x its padded forwards, each
     image bitwise its lone emulated generate, drain seconds).
 20. K1 and K2 over a video frame's 2N context (8192 rows: the frame's own
     published K/V and the previous frame's, joined by ``torch.cat`` as
     the path joins them): K1 at Nl 2304 / 1792 / 4096 / 2048 / 200, batch
     1 and the guided batch 2, K2 at n_tokens 8192 over 8192 + Nl_max rows
     (Nl_max 2048 and 2304), fp32 and bf16, with the bars and planted
     faults of phases 3 and 6 plus the previous frame's half dropped (K1)
     and n_tokens of one frame (K2); times at bf16 against the bound and
     SDPA over the same context (``k1_ctx2n_check``, ``k2_ctx2n_check``).
 21. the video paths on sdxl-dit, 4 frames (frame 0 the main path's x_T):
     frame-sequential on the main path's cluster unguided
     (``frames_check``) and fused guided (``frames_guided_check``), each
     driven as in phase 9 (K1 and K3 from the trace, once a frame), frame 0
     bitwise the image path's; the stadi_video plan on [0.0, 0.0, 0.5,
     0.5] with two frame rows (``stadi_video_check``), bitwise the
     frame-sequential executor on its plan; the video serving lanes, three
     clips on 2 slots (``diffusion_serve_video``: launches three times the
     generate's, the first clip bitwise its lone generate).
 22. spmd_frames on that plan, 2 frame rows x 2 columns (gloo ranks sharing
     the card; NCCL a card each under --nccl): each rank's K1 and K2 those
     of its row's frames, the video equal on every rank and within 1e-2 of
     the emulated video (bitwise printed), the handoffs' and gathers'
     seconds a rank from a generate under the collectives wrapper
     (``spmd_frames_check``).
 23. prompt conditioning on sdxl-dit .text_conditioned(32), bf16, weights
     from SEED (the class leaves bitwise phase 9's): the main path's plan on
     a 7-word prompt (bucket 8) from the port's tower (``prompt_check``:
     launches the class path's 616 K1, seconds beside the class path's
     in this call, another prompt of its bucket steers the image apart and
     a shorter one (bucket 4) by more than 1e-2, class ids
     under the text config bitwise the class path, the tower's time, and
     a profiled generate with the cross-attention's and the tower's
     device time, ``prompt_profile``); fused guidance 4.0
     (``prompt_guided_check``: 22 K3 as the class guided path, the fused
     null branch bitwise an explicit null_cond forward, the read of the
     null sequence exactly 0.0 in bf16); a 2-frame guided video on the
     stadi_video plan at [0.0, 0.0, 0.5, 0.5] (``prompt_video_check``:
     frame 0 bitwise the guided image on its schedule); six prompt requests
     of buckets 8, 8, 4, 32, 4, 32 (two guided) on 4 slots
     (``diffusion_serve_prompt``: launches from the dispatches, dispatches
     by guidance and bucket, each image bitwise its lone generate, drain
     seconds).
 Phases 13 to 15 run after phase 8, before the sdxl-dit paths; phase 16
 after phase 10, 17 after 7, 18 after 16, 19 after 11, 20 after 17, 21
 after 18, 23 after 21 and 22 after 11.
Every path is driven with the launch counters set to 0 just before it and
read just after (on every rank for the multi-rank paths). The
second-to-last line is the kernels' JSON record, the last line the device
record.
"""
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
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
TILE = 64                           # key rows the planted faults skip or shift
# sdxl-dit's eps per guidance branch: the two patches and the full image
# (the warm-up), and an odd length for the kernel's scalar tail
K3_SHAPES = [(1, 72, 128, 4), (1, 56, 128, 4), (1, 128, 128, 4), (36865,)]
CFG_SCALE = 4.0
# the serving engine's guided lane groups: G lanes of the first patch and of
# the warm-up, and a lane of 105 elements (no whole 16-byte vectors a lane)
K3_GROUPS = (1, 2, 4)
K3_LANES = [(72, 128, 4), (128, 128, 4), (5, 7, 3)]
K3_LANE_SCALES = (3.0, 5.0, 3.0, 5.0)


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


def host_us(fn, reps=50):
    """Host time of one call in microseconds: perf_counter around ``reps``
    back-to-back calls that only enqueue (the card runs behind them), after
    a warm-up. For a kernel wrapper this is the Python checks, the argument
    marshalling (K1, K2, K4, K5: the key runs and ten tensor maps) and the
    launch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e6


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
                            bound_ms=bound_ms, bound_by=bound_by,
                            wrapper_host_us=host_us(lambda: ops.stale_kv_attention(
                                q, kf, vf, ks, vs, tok_start=tok)))
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
                bound_ms=bound_ms, bound_by=bound_by,
                wrapper_host_us=host_us(lambda: ops.stale_kv_attention(
                    q, kf, vf, ks, vs, tok_start=tok)))
            reading = line
        print("k1_batch2_check", json.dumps(line), flush=True)
        check(ok, f"K1 at batch 2 disagrees with its plain version: {line}")
        check(all(not passed for _, _, passed in faults.values()),
              f"the K1 bar lets a planted fault through at batch 2: {line}")
    return reading


#: the serving lanes' batches: K1 over G lanes of the pipefuse stepper (the
#: stale context a slot range of the [L, slots, N, H, hd] displaced
#: contexts: (G, first slot)) and K2 over a cohort of G lanes of the spmd
#: stepper
K1_LANES = [(2, 1), (4, 0)]
K2_COHORTS = (4,)


def phase_k1_lanes(ops, ref, layers, dev, peaks):
    """K1 at the pipefuse serving lanes' batches: q/k/v of G lanes, the
    stale K/V the [G, N, H, hd] slot-range view of one layer of the
    [L, 4 slots, N, H, hd] displaced contexts (read in place), at the main
    path's patch layouts, fp32 and bf16, with K1's bars and planted faults;
    times at G 4, bf16. Returns the bf16 G 4 reading of the first patch."""
    F = torch.nn.functional
    gen = torch.Generator(device="cpu").manual_seed(SEED + 8)
    H, hd, L, slots = 16, 72, 2, 4
    reading = None
    for dtype in (torch.float32, torch.bfloat16):
        for G, first in K1_LANES:
            for N, Nl, tok in SDXL_CASES[:2]:
                def mk(*shape, std=1.0):
                    return (std * torch.randn(*shape, generator=gen)
                            ).to(dtype).to(dev)
                ctx_k = mk(L, slots, N, H, hd, std=QK_STD)
                ctx_v = mk(L, slots, N, H, hd)
                ks = ctx_k[:, first:first + G][1]
                vs = ctx_v[:, first:first + G][1]
                check(ks.data_ptr() == ctx_k[1, first].data_ptr(),
                      "the lanes' context is not read in place")
                q, kf, vf = (mk(G, Nl, H, hd, std=s)
                             for s in (QK_STD, QK_STD, 1.0))
                out = ops.stale_kv_attention(q, kf, vf, ks, vs, tok_start=tok)
                want = ref.stale_kv_attention_ref(q, kf, vf, ks, vs, tok)
                line = {"kernel": "stale_kv_attention", "lanes": G,
                        "first_slot": first, "dtype": str(dtype), "N": N,
                        "Nl": Nl, "tok_start": tok}
                if dtype == torch.bfloat16 and G == 4:
                    full_k, full_v = ks.clone(), vs.clone()
                    full_k[:, tok:tok + Nl] = kf
                    full_v[:, tok:tok + Nl] = vf
                    qt, kt, vt = (t.transpose(1, 2) for t in (q, full_k, full_v))
                    bound_ms, bound_by = k1_bound_ms(G, H, Nl, N, hd, dtype,
                                                     peaks)
                    line.update(
                        ms=time_ms(lambda: ops.stale_kv_attention(
                            q, kf, vf, ks, vs, tok_start=tok)),
                        plain_ms=time_ms(lambda: ref.stale_kv_attention_ref(
                            q, kf, vf, ks, vs, tok), reps=3),
                        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                            qt, kt, vt)),
                        bound_ms=bound_ms, bound_by=bound_by)
                check_with_faults("k1_lanes_check", out, want, k1_planted_faults(
                    layers, ref, q, kf, vf, ks, vs, tok), dtype, line)
                if reading is None and "ms" in line:
                    reading = line
    return reading


def phase_k2_cohorts(ops, ref, dev, peaks):
    """K2 at the spmd serving stepper's cohort batches (G lanes of one fine
    step stacked on the batch axis) at the spmd path's rank layouts, fp32
    and bf16, with K2's bars and planted faults; times at bf16. Returns the
    bf16 rank-0 reading."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 9)
    reading = None
    for dtype in (torch.float32, torch.bfloat16):
        for G in K2_COHORTS:
            for tok, valid in K2_LAYOUTS[:2]:
                args = k2_inputs(dtype, dev, gen, G)
                out = ops.stale_kv_attention_padded(*args, tok, valid,
                                                    n_tokens=K2_N)
                want = ref.stale_kv_attention_padded_ref(*args, tok, valid, K2_N)
                line = {"kernel": "stale_kv_attention_padded", "lanes": G,
                        "dtype": str(dtype), "tok_start": tok,
                        "valid_tokens": valid, "n_tokens": K2_N,
                        "Nl_max": K2_NL, "Npad": K2_NPAD}
                if dtype == torch.bfloat16:
                    bound_ms, bound_by = k2_bound_ms(G, tok, valid, dtype, peaks)
                    line.update(
                        ms=time_ms(lambda: ops.stale_kv_attention_padded(
                            *args, tok, valid, n_tokens=K2_N)),
                        plain_ms=time_ms(lambda: ref.stale_kv_attention_padded_ref(
                            *args, tok, valid, K2_N), reps=3),
                        library_ms=time_ms(k2_library_call(args, tok, valid)),
                        bound_ms=bound_ms, bound_by=bound_by)
                check_with_faults("k2_cohort_check", out, want,
                                  k2_planted_faults(
                                      ref.stale_kv_attention_padded_ref, args,
                                      tok, valid), dtype, line)
                if reading is None and "ms" in line:
                    reading = line
    return reading


def k3_bound_ms(n, dtype, peaks, with_delta=True):
    """Least time for K3's work: eps_c and eps_u read once, the combine (eps
    dtype) and, with delta, the fp32 delta written once, at the memory rate;
    or three fp32 operations an element at the CUDA-core peak."""
    elem = torch.tensor([], dtype=dtype).element_size()
    bytes_ms = n * (3 * elem + (4 if with_delta else 0)) / peaks[2] * 1e3
    ops_ms = 3 * n / peaks[1] * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def k3_pair(n, dtype, dev, gen, offset=0):
    """eps_c, eps_u of n elements, ``offset`` elements into a larger buffer
    (offset 1: contiguous but not 16-byte aligned)."""
    return [torch.randn(n + offset, generator=gen).to(dtype).to(dev)[offset:]
            for _ in range(2)]


def phase_k3(ops, ref, dev, peaks):
    """K3 bitwise against its plain version: one scalar scale at the guided
    generate's eps shapes, and per-lane scales over lane groups of G = 1, 2
    and 4 (the serving engine's guided dispatches; a lane of 105 elements
    takes the scalar path), each with the planted fault of lane 0's scale
    used for every lane rejected. Times at the serving shapes against the
    byte bound and the launch floor (an empty kernel, graph-replayed the
    same way). Returns the reading at the first patch's shape, G = 1, with
    delta (generate's form), with the timed lines under ``lane_groups``."""
    from repro_torch.kernels import cfg_epilogue as cfe

    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    lib = ops.load_library().lib
    floor_ms = time_graph_ms(lambda: cfe.launch_empty(lib, dev))
    first, timed = None, []
    cases = [(shape, None) for shape in K3_SHAPES]
    cases += [((G,) + lane, K3_LANE_SCALES[:G]) for G in K3_GROUPS
              for lane in K3_LANES]
    for dtype in (torch.float32, torch.bfloat16):
        for shape, lane_scales in cases:
            n = math.prod(shape)
            scale = (CFG_SCALE if lane_scales is None
                     else torch.tensor(lane_scales, device=dev))
            for offset in (0, 1):
                ec, eu = (t.view(shape) for t in k3_pair(n, dtype, dev, gen, offset))
                comb, delta = ops.cfg_epilogue(ec, eu, scale)
                only = ops.cfg_epilogue(ec, eu, scale, with_delta=False)
                want_comb, want_delta = ref.cfg_epilogue_ref(ec, eu, scale)
                line = {"kernel": "cfg_epilogue", "dtype": str(dtype),
                        "shape": list(shape), "offset": offset,
                        "G": shape[0] if lane_scales else None,
                        "max_abs_err": (comb.float() - want_comb.float()).abs().max().item(),
                        "delta_max_abs_err": (delta - want_delta).abs().max().item(),
                        "bitwise": bool(torch.equal(comb, want_comb)
                                        and torch.equal(delta, want_delta)
                                        and torch.equal(only, want_comb))}
                if lane_scales is not None and shape[0] > 1:
                    fault = ops.cfg_epilogue(ec, eu, scale[0], with_delta=False)
                    line["planted_fault_rejected"] = not torch.equal(fault, want_comb)
                    check(line["planted_fault_rejected"],
                          f"K3's check lets lane 0's scale for every lane through: {line}")
                print("k3_check", json.dumps(line), flush=True)
                check(line["bitwise"],
                      f"K3 is not bitwise equal to its plain version: {line}")
                if (dtype != torch.bfloat16 or offset or len(shape) != 4
                        or shape[1:] == K3_LANES[-1]):
                    continue
                for with_delta in (True, False):
                    if lane_scales is None and not with_delta:
                        continue
                    timed.append(k3_timed(ops, ref, ec, eu, scale, with_delta,
                                          line, floor_ms, peaks))
                    if first is None:
                        first = timed[-1]
    first["lane_groups"] = timed
    return first


def k3_timed(ops, ref, ec, eu, scale, with_delta, line, floor_ms, peaks):
    """One timed K3 line: the kernel, the launch floor, the plain version and
    the nearest library calls (``torch.lerp`` with a [G, 1, 1, 1] weight, and
    ``torch.sub`` into fp32 for the delta), all graph-replayed; and the
    wrapper's eager time per call."""
    n, G = ec.numel(), ec.shape[0]
    per_lane = isinstance(scale, torch.Tensor)
    weight = scale.view(G, 1, 1, 1).to(ec.dtype) if per_lane else scale
    d32 = torch.empty(ec.shape, dtype=torch.float32, device=ec.device)

    def library():
        torch.lerp(eu, ec, weight)
        if with_delta:
            torch.sub(ec, eu, out=d32)
    kernel = lambda: ops.cfg_epilogue(ec, eu, scale, with_delta=with_delta)
    bound_ms, bound_by = k3_bound_ms(n, ec.dtype, peaks, with_delta)
    out = {k: line[k] for k in ("kernel", "dtype", "shape", "G", "max_abs_err")}
    out.update(with_delta=with_delta, per_lane=per_lane,
               ms=time_graph_ms(kernel), floor_ms=floor_ms,
               plain_ms=time_graph_ms(lambda: ref.cfg_epilogue_ref(ec, eu, scale)),
               library_ms=time_graph_ms(library),
               eager_ms=time_ms(kernel, reps=100),
               bound_ms=bound_ms, bound_by=bound_by)
    print("k3_check", json.dumps(out), flush=True)
    return out


# K2's layouts: (tok_start, valid_tokens) of rank 0 and rank 1 of the spmd
# main path (patches [36, 28] token rows of 64 tokens, slab Nl_max 2304),
# and rank 0 of the reversed split [28, 36], the one layout of the three at
# which ignoring valid_tokens changes the output (at the other two the slab's
# scratch rows land on keys the scratch mask removes anyway)
K2_N, K2_NL, K2_NPAD = 4096, 2304, 6400
K2_LAYOUTS = [(0, 2304), (2304, 1792), (0, 1792)]


def k2_inputs(dtype, dev, gen, B, lead=(), nl=K2_NL, npad=K2_NPAD):
    """q, k_fresh, v_fresh of [*lead, B, Nl_max, 16, 72] and the stale
    K/V of [*lead, B, Npad, 16, 72]: random everywhere, the slab's rows past
    valid_tokens and the buffer's scratch tail included, so that a dropped
    mask or blend shows; q and k of std QK_STD as for K1."""
    def mk(n, std):
        return (std * torch.randn(*lead, B, n, 16, 72, generator=gen)
                ).to(dtype).to(dev)
    return (mk(nl, QK_STD), mk(nl, QK_STD), mk(nl, 1.0),
            mk(npad, QK_STD), mk(npad, 1.0))


def k2_planted_faults(plain, args, tok, valid, n=K2_N):
    """K2's output under planted faults, from its plain version ``plain``
    (called as ``plain(*args, tok_start, valid_tokens, n_tokens)``):
    valid_tokens ignored (the whole slab fresh), the scratch key mask
    dropped, tok_start off by one 64-key tile."""
    nl, npad = args[0].shape[-3], args[3].shape[-3]
    shifted = tok + TILE if tok + TILE <= npad - nl else tok - TILE
    return {"valid_tokens ignored": plain(*args, tok, nl, n),
            "scratch mask dropped": plain(*args, tok, valid, npad),
            f"tok_start {shifted - tok:+d}": plain(*args, shifted, valid, n)}


def k2_bound_ms(B, tok, valid, dtype, peaks, nl=K2_NL, n=K2_N):
    """Least time for K2's work: every slab row's query against the n_tokens
    real keys, 4*B*H*Nl_max*n_tokens*hd operations at the input type's
    peak, or its bytes (q and the output once; the fresh rows the function
    reads and the stale rows it reads, each once) at the memory rate."""
    H, hd = 16, 72
    flops = 4 * B * H * nl * n * hd
    fresh = max(0, min(valid, n - tok))
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = elem * B * H * hd * (2 * nl + 2 * fresh + 2 * (n - fresh))
    ops_ms = flops / (peaks[0] if dtype == torch.bfloat16 else peaks[1]) * 1e3
    bytes_ms = nbytes / peaks[2] * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def k2_library_call(args, tok, valid, n=K2_N):
    """The library yardstick for K2 (and K5 folded to batch 2B): one
    scaled_dot_product_attention call over the K/V materialized with the
    fresh rows written in, the scratch keys masked by a boolean mask."""
    q, kf, vf, ks, vs = args
    full_k, full_v = ks.clone(), vs.clone()
    full_k[:, tok:tok + valid] = kf[:, :valid]
    full_v[:, tok:tok + valid] = vf[:, :valid]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, full_k, full_v))
    keep = (torch.arange(ks.shape[1], device=q.device) < n)[None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep)


def check_with_faults(label, out, want, faults, dtype, line):
    """Hold ``out`` to ``want`` with K1's bars, and require the bar to
    reject every planted fault that changes the function at this layout (a
    fault whose plain output is within 1e-6 norm-relative of the correct
    plain output is reported as unchanged there, not as rejected)."""
    err, rel, ok = k1_reading(out, want, dtype)
    readings = {}
    for name, bad in faults.items():
        moved = ((bad.float() - want.float()).norm() / want.float().norm()).item()
        if moved < 1e-6:
            readings[name] = {"unchanged_at_this_layout": moved}
            continue
        e, r, passed = k1_reading(out, bad, dtype)
        readings[name] = {"max_abs_err": e, "norm_rel_err": r,
                          "rejected": not passed}
    line.update(max_abs_err=err, norm_rel_err=rel, ok=ok,
                planted_faults=readings)
    print(label, json.dumps(line), flush=True)
    check(ok, f"{label}: kernel disagrees with its plain version: {line}")
    check(all(f.get("rejected", True) for f in readings.values()),
          f"{label}: the bar lets a planted fault through: {line}")
    return readings


def phase_k2(ops, ref, dev, peaks):
    """K2 against its plain version at the spmd main path's layouts, batch
    1 and 2 (fused guidance), fp32 and bf16, with planted faults; times at
    the bf16 layouts of the path. Returns the timed readings, the batch-1
    rank-0 one first."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 4)
    timed, rejected = [], set()
    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 2):
            for tok, valid in K2_LAYOUTS:
                args = k2_inputs(dtype, dev, gen, B)
                out = ops.stale_kv_attention_padded(*args, tok, valid,
                                                    n_tokens=K2_N)
                want = ref.stale_kv_attention_padded_ref(*args, tok, valid, K2_N)
                line = {"kernel": "stale_kv_attention_padded", "dtype": str(dtype),
                        "batch": B, "tok_start": tok, "valid_tokens": valid,
                        "n_tokens": K2_N, "Nl_max": K2_NL, "Npad": K2_NPAD,
                        "bar": BARS[dtype], "norm_bar": NORM_BARS[dtype]}
                if dtype == torch.bfloat16 and (tok, valid) != K2_LAYOUTS[2]:
                    bound_ms, bound_by = k2_bound_ms(B, tok, valid, dtype, peaks)
                    line.update(
                        ms=time_ms(lambda: ops.stale_kv_attention_padded(
                            *args, tok, valid, n_tokens=K2_N)),
                        plain_ms=time_ms(lambda: ref.stale_kv_attention_padded_ref(
                            *args, tok, valid, K2_N), reps=3),
                        library_ms=time_ms(k2_library_call(args, tok, valid)),
                        bound_ms=bound_ms, bound_by=bound_by,
                        wrapper_host_us=host_us(lambda: ops.stale_kv_attention_padded(
                            *args, tok, valid, n_tokens=K2_N)))
                faults = check_with_faults(
                    "k2_check", out, want, k2_planted_faults(
                        ref.stale_kv_attention_padded_ref, args, tok, valid),
                    dtype, line)
                rejected |= {n for n, f in faults.items() if f.get("rejected")}
                if "ms" in line:
                    timed.append(line)
    check(len(rejected) == 3, f"K2: not every planted fault was shown "
          f"rejected at some layout: {sorted(rejected)}")
    return timed


def phase_k5(ops, ref, dev, peaks):
    """K5 (both guidance branches in one launch) against its plain version
    with uncond_fresh 0 and 1, fp32 and bf16, at the layouts and with the
    planted faults of K2; times at rank 1's bf16 layout. Returns that
    reading with uncond_fresh 1."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 5)
    reading, rejected = None, set()
    for dtype in (torch.float32, torch.bfloat16):
        for uncond_fresh in (1, 0):
            for tok, valid in K2_LAYOUTS:
                args = k2_inputs(dtype, dev, gen, 1, lead=(2,))
                out = ops.stale_kv_attention_guided(*args, tok, valid,
                                                    uncond_fresh, n_tokens=K2_N)

                def plain(*a, uf=uncond_fresh):
                    return ref.stale_kv_attention_guided_ref(*a[:-1], uf, a[-1])
                want = plain(*args, tok, valid, K2_N)
                line = {"kernel": "stale_kv_attention_guided", "dtype": str(dtype),
                        "uncond_fresh": uncond_fresh, "tok_start": tok,
                        "valid_tokens": valid, "n_tokens": K2_N,
                        "Nl_max": K2_NL, "Npad": K2_NPAD}
                if (dtype == torch.bfloat16 and uncond_fresh == 1
                        and (tok, valid) == K2_LAYOUTS[1]):
                    bound_ms, bound_by = k2_bound_ms(2, tok, valid, dtype, peaks)
                    line.update(
                        ms=time_ms(lambda: ops.stale_kv_attention_guided(
                            *args, tok, valid, 1, n_tokens=K2_N)),
                        plain_ms=time_ms(lambda: plain(*args, tok, valid, K2_N),
                                         reps=3),
                        library_ms=time_ms(k2_library_call(
                            [t.flatten(0, 1) for t in args], tok, valid)),
                        bound_ms=bound_ms, bound_by=bound_by,
                        wrapper_host_us=host_us(lambda: ops.stale_kv_attention_guided(
                            *args, tok, valid, 1, n_tokens=K2_N)))
                faults = check_with_faults(
                    "k5_check", out, want,
                    k2_planted_faults(plain, args, tok, valid), dtype, line)
                rejected |= {n for n, f in faults.items() if f.get("rejected")}
                if "ms" in line:
                    reading = line
    check(len(rejected) == 3, f"K5: not every planted fault was shown "
          f"rejected at some layout: {sorted(rejected)}")
    return reading


# K4's cases: spmd_seq's two hops on sdxl-dit at S = 2 (segments of 3200 rows
# of the 6400-row scratch-padded buffer, 4096 keys real: 3200 and 896 real),
# an empty segment (as at S = 4) and a length aligned to no tile
K4_SQ, K4_HS, K4_T = 4608, 8, 3200
K4_VALIDS = [3200, 896, 0, 1001]


def k4_inputs(dtype, dev, gen):
    """q [1, 4608, 8, 72] (the Ulysses-scattered slab of both seq members);
    k, v the second head group of a [1, 3200, 16, 72] segment, strided
    views as the ring reads them; q and k of std QK_STD."""
    q = (QK_STD * torch.randn(1, K4_SQ, K4_HS, 72, generator=gen)).to(dtype)
    hold = torch.randn(2, 1, K4_T, 2 * K4_HS, 72, generator=gen)
    hold[0] *= QK_STD
    hold = hold.to(dtype).to(dev)
    return q.to(dev), hold[0][:, :, K4_HS:], hold[1][:, :, K4_HS:]


def k4_planted_faults(ref, q, k, v, valid):
    """K4's (out, lse) under planted faults, from its plain version:
    valid_len ignored, the segment shifted by one 64-key tile (zeros past
    its end), the LSE without its log l term (the row max alone)."""
    def shift(t):
        return torch.cat([t[:, TILE:], torch.zeros_like(t[:, :TILE])], 1)
    want_out, _ = ref.lse_attention_ref(q, k, v, valid)
    faults = {"valid_len ignored": ref.lse_attention_ref(q, k, v, k.shape[1]),
              f"segment shifted +{TILE}": ref.lse_attention_ref(
                  q, shift(k), shift(v), valid)}
    if valid:
        scores = torch.einsum("bshd,bthd->bsht", q.float(), k[:, :valid].float())
        faults["lse without log l"] = (want_out,
                                       scores.amax(-1) * q.shape[-1] ** -0.5)
    return faults


def k4_reading(out, lse, want, dtype):
    """(max abs error of out, its norm-relative error, max abs error of the
    lse, within the bars: K1's for out in its dtype, fp32's on the lse)."""
    err, rel, ok = k1_reading(out, want[0], dtype)
    lerr, _, lok = k1_reading(lse, want[1], torch.float32)
    return err, rel, lerr, ok and lok


def k4_bound_ms(valid, dtype, peaks):
    """Least time for K4's work on this segment: 4*Hs*Sq*valid*hd operations
    at the input type's peak, or the bytes (q and out once, the valid K/V
    rows once, the fp32 lse once) at the memory rate."""
    flops = 4 * K4_HS * K4_SQ * valid * 72
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = elem * K4_HS * 72 * (2 * K4_SQ + 2 * valid) + 4 * K4_SQ * K4_HS
    ops_ms = flops / (peaks[0] if dtype == torch.bfloat16 else peaks[1]) * 1e3
    bytes_ms = nbytes / peaks[2] * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def phase_k4(ops, ref, dev, peaks):
    """K4 against its plain version at spmd_seq's hop shapes, an empty and an
    unaligned segment, fp32 and bf16, with planted faults; times at the two
    bf16 hops of the path. Returns the timed readings, valid 3200 first."""
    F = torch.nn.functional
    gen = torch.Generator(device="cpu").manual_seed(SEED + 6)
    timed, rejected = [], set()
    for dtype in (torch.float32, torch.bfloat16):
        for valid in K4_VALIDS:
            q, k, v = k4_inputs(dtype, dev, gen)
            out, lse = ops.lse_attention(q, k, v, valid)
            want = ref.lse_attention_ref(q, k, v, valid)
            line = {"kernel": "lse_attention", "dtype": str(dtype),
                    "q": list(q.shape), "kv": list(k.shape), "kv_strided":
                    not k.is_contiguous(), "valid_len": valid,
                    "bar": BARS[dtype], "norm_bar": NORM_BARS[dtype]}
            if valid == 0:            # out 0, lse the sentinel: zero weight
                ok = (torch.equal(out, torch.zeros_like(out))
                      and torch.equal(lse, want[1])
                      and lse.max().item() <= -1e29)
                line.update(max_abs_err=(out.float() - want[0].float()).abs()
                            .max().item(), lse_max=lse.max().item(), ok=ok)
                print("k4_check", json.dumps(line), flush=True)
                check(ok, f"K4 at an empty segment: {line}")
                continue
            err, rel, lerr, ok = k4_reading(out, lse, want, dtype)
            readings = {}
            for name, bad in k4_planted_faults(ref, q, k, v, valid).items():
                moved = max(((b.float() - w.float()).norm()
                             / w.float().norm()).item() for b, w in zip(bad, want))
                if moved < 1e-6:
                    readings[name] = {"unchanged_at_this_layout": moved}
                    continue
                e, r, le, passed = k4_reading(out, lse, bad, dtype)
                readings[name] = {"max_abs_err": e, "norm_rel_err": r,
                                  "lse_max_abs_err": le, "rejected": not passed}
                if not passed:
                    rejected.add(name)
            line.update(max_abs_err=err, norm_rel_err=rel, lse_max_abs_err=lerr,
                        ok=ok, planted_faults=readings)
            if dtype == torch.bfloat16 and valid in (3200, 896):
                bound_ms, bound_by = k4_bound_ms(valid, dtype, peaks)
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k[:, :valid],
                                                          v[:, :valid]))
                line.update(
                    ms=time_ms(lambda: ops.lse_attention(q, k, v, valid)),
                    plain_ms=time_ms(lambda: ref.lse_attention_ref(
                        q, k, v, valid), reps=3),
                    library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt)),
                    library_call="scaled_dot_product_attention over "
                                 "k[:, :valid_len], unmasked; no LSE returned",
                    bound_ms=bound_ms, bound_by=bound_by,
                    wrapper_host_us=host_us(lambda: ops.lse_attention(
                        q, k, v, valid)))
                timed.append(line)
            print("k4_check", json.dumps(line), flush=True)
            check(ok, f"K4 disagrees with its plain version: {line}")
            check(all(f.get("rejected", True) for f in readings.values()),
                  f"the K4 bar lets a planted fault through: {line}")
    check(len(rejected) == 3, f"K4: not every planted fault was shown "
          f"rejected at some segment: {sorted(rejected)}")
    return timed


def _expected_launches(result, n_layers):
    """Launches a generate must make, from its trace: K1 once per layer of
    every denoiser eval (one full-image eval per warm-up step, one patch
    eval per substep; a guided eval runs both branches in one launch), and
    on a guided run K3 once per eval whose uncond branch is computed
    (interleaved reuse evals run the cond branch alone and apply the
    cached delta instead); a video's eval runs once a frame."""
    trace = result.trace
    evals = fresh = 0
    for e in trace.events:                   # a video evaluates every frame
        subs = [1] if e.synchronous else e.substeps
        evals += sum(subs) * e.frames
        fresh += e.frames * sum(s for i, s in enumerate(subs)
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


def sdxl_setup(dev):
    """sdxl-dit at full width (bf16) with random nondegenerate weights, its
    x_T and class, all from SEED on ``dev``: the script and every rank of
    the spmd phase build the same."""
    from repro_torch.configs import get_config
    from repro_torch.models.diffusion import dit

    cfg = get_config("sdxl-dit")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = dit.nondegenerate_params(dit.init_params(gen, cfg), gen)
    cond = torch.tensor([SEED % cfg.n_classes], device=dev)
    return cfg, params, main_x_T(cfg, dev), cond


def main_x_T(cfg, dev):
    """The main path's x_T, from SEED + 3 on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    return torch.randn(1, cfg.latent_size, cfg.latent_size, cfg.channels,
                       generator=gen, device=dev).to(torch.bfloat16)


def tiny_setup():
    """tiny-dit.reduced() in fp32, weights, x_T and classes from SEED on the
    CPU (the pipeline moves them to its device)."""
    from repro_torch.configs import get_config
    from repro_torch.models.diffusion import dit

    cfg = get_config("tiny-dit").reduced()
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    params = dit.nondegenerate_params(dit.init_params(gen, cfg), gen)
    x_T = torch.randn(2, cfg.latent_size, cfg.latent_size, cfg.channels,
                      generator=gen)
    return cfg, params, x_T, torch.tensor([1, 2])


def drive_path(ops, label, cfg, params, x_T, cond, config, dev, profile=True):
    """Drive one path through ``StadiPipeline.generate`` on sdxl-dit: a
    warm-up call, then a generate with the launch counters set to 0 just
    before it and read just after, checked against the trace, then (with
    ``profile``) one more under the profiler. Returns (the launches, the
    image, the seconds of the counted generate)."""
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiPipeline

    sched = sampler.linear_schedule(1000)
    pipe = StadiPipeline(cfg, params, sched, config, device=dev)
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
    check(tuple(img.shape) == tuple(x_T.shape),
          f"{label}: image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img.float()).all()), f"{label}: non-finite image")
    check(launches == expected and all(expected.values()),
          f"{label}: launches {launches}, the trace needs {expected}")
    check(res.kernel_stats == {"launches": launches},
          f"{label}: kernel_stats mismatch")
    if profile:
        profile_generate(pipe, x_T, cond, seconds, label)
    return launches, img, seconds


def phase_paths(ops, dev):
    """The main path and the two guided paths on one set of sdxl-dit
    weights. Returns {label: launches}."""
    from repro_torch.core.pipeline import StadiConfig

    cfg, params, x_T, cond = sdxl_setup(dev)
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
    return {label: drive_path(ops, label, cfg, params, x_T, cond, config,
                              dev)[0]
            for label, config in paths.items()}


# diffusion_serve traffic on 4 slots: (cfg_scale, round it is submitted
# before). Two guided requests at round 0, then four after round 2: two
# take the free slots next to lanes three fine steps ahead (one guided
# dispatch then carries lanes at two timesteps and two scales), two queue
# until the first wave retires
SERVE_SLOTS = 4
SERVE_TRAFFIC = [(3.0, 0), (5.0, 0), (None, 3), (3.0, 3), (5.0, 3), (None, 3)]
SERVE_PROFILED_ROUND = 10           # warm-up and adaptive lanes, both kinds


def serve_inputs(cfg, dev):
    """The x_T and class of each SERVE_TRAFFIC request, from SEED on
    ``dev`` (every rank and the script build the same)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    xs = [torch.randn(1, cfg.latent_size, cfg.latent_size, cfg.channels,
                      generator=gen, device=dev).to(torch.bfloat16)
          for _ in SERVE_TRAFFIC]
    return xs, [(SEED + 7 * i) % cfg.n_classes for i in range(len(xs))]


def serve_drain(engine, xs, conds, traffic, sync=False, stop=None):
    """Submit ``traffic`` to ``engine`` round by round and drain it (or stop
    before round ``stop``). Returns (requests, seconds of each round; each
    synchronised with the card when ``sync``)."""
    reqs, walls, r = [None] * len(traffic), [], 0
    while engine.queue or engine.active or None in reqs:
        if r == stop:
            break
        for i, (scale, at) in enumerate(traffic):
            if at == r:
                reqs[i] = engine.submit(xs[i], conds[i], cfg_scale=scale)
        t0 = time.perf_counter()
        engine.step()
        if sync:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        r += 1
    return reqs, walls


def serve_expected_launches(stats, n_layers):
    """Launches a drain must make, from the engine's own dispatch count: K1
    once a layer of every denoiser dispatch, K3 once per guided dispatch
    (whatever its lane count)."""
    d = stats["dispatches"]
    return {"stale_kv_attention": n_layers * (d.get("plain", 0) + d.get(
                "guided", 0) + d.get("bootstrap", 0)),
            "cfg_epilogue": d.get("guided", 0)}


def phase_diffusion_serve(ops, dev):
    """The diffusion serving path: sdxl-dit at full width on the main path's
    emulated plan, 6 requests on 4 slots through DiffusionServingEngine
    (SERVE_TRAFFIC): a warm-up drain, the measured drain with the launch
    counters set to 0 just before it, one round of a third drain under the
    profiler; each served image against a lone generate of its request;
    then tiny-dit.reduced() fp32 served on the card against the CPU.
    Returns the measured drain's launches."""
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiConfig, StadiPipeline
    from repro_torch.serving import DiffusionServingEngine

    cfg, params, _, _ = sdxl_setup(dev)
    sched = sampler.linear_schedule(1000)
    config = StadiConfig.from_occupancies([0.0, 0.5], m_base=16, m_warmup=4,
                                          planner="stadi", backend="emulated",
                                          exchange="sync")
    pipe = StadiPipeline(cfg, params, sched, config, device=dev)
    xs, conds = serve_inputs(cfg, dev)
    t0 = time.perf_counter()
    serve_drain(DiffusionServingEngine(pipe, slots=SERVE_SLOTS), xs, conds,
                SERVE_TRAFFIC)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    engine = DiffusionServingEngine(pipe, slots=SERVE_SLOTS)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs, walls = serve_drain(engine, xs, conds, SERVE_TRAFFIC, sync=True)
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    stats = engine.stats()
    expected = serve_expected_launches(stats, cfg.n_layers)
    d = stats["dispatches"]
    # a guided warm-up dispatch of round 3 carries lanes at two timesteps
    # (fine steps 3 and 0) and both scales
    r3 = engine.rounds[3]
    mixed = sorted(s for s in r3.warmup_lanes if s != 2)   # slot 2: unguided
    rels = []
    for i, req in enumerate(reqs):
        scale = SERVE_TRAFFIC[i][0]
        lone = StadiPipeline(cfg, params, sched, dataclasses.replace(
            config, cfg_scale=scale or 0.0), device=dev).generate(
                xs[i], torch.tensor([conds[i]], device=dev)).image
        rels.append(((req.image.float() - lone.float()).norm()
                     / lone.float().norm()).item())
    line = {
        "slots": SERVE_SLOTS, "traffic": SERVE_TRAFFIC, "plan_patches":
        engine.plan.patches, "plan_steps": engine.plan.temporal.steps,
        "drain_s": seconds, "first_drain_s": first_s,
        "images_per_s": len(reqs) / seconds, "rounds": len(engine.rounds),
        "round_walls_s": walls, "dispatches": d, "launches": launches,
        "expected_launches": expected,
        "round3_guided_warmup_slots": mixed,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "requests": [{**r, "cfg_scale": SERVE_TRAFFIC[i][0],
                      "rel_err_vs_generate": rels[i]}
                     for i, r in enumerate(stats["requests"])]}
    print("diffusion_serve", json.dumps(line), flush=True)
    check(all(r.done and bool(torch.isfinite(r.image.float()).all())
              for r in reqs), "diffusion_serve: a request did not finish finite")
    check(launches == expected and all(expected.values()),
          f"diffusion_serve: launches {launches}, the dispatches need {expected}")
    check(d["guided_lanes"] > d["guided"],
          "diffusion_serve: no guided dispatch carried more than one lane")
    check(mixed == [0, 1, 3], f"diffusion_serve: round 3's guided warm-up "
          f"group is {mixed}, not lanes at fine steps 3 and 0 together")
    check(max(rels) < 1e-2, f"diffusion_serve: served images off their lone "
          f"generate by {rels}")
    profile_serve_round(pipe, xs, conds, walls[SERVE_PROFILED_ROUND])
    serve_cross_device(dev)
    return launches


def profile_serve_round(pipe, xs, conds, wall_s, top=12):
    """Round SERVE_PROFILED_ROUND of a third drain under torch.profiler:
    device time by kernel and the idle share against the measured drain's
    synchronised wall time of the same round."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import DiffusionServingEngine

    engine = DiffusionServingEngine(pipe, slots=SERVE_SLOTS)
    serve_drain(engine, xs, conds, SERVE_TRAFFIC, stop=SERVE_PROFILED_ROUND)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.step()
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((ev.key, dev_us, ev.count))
    kernels.sort(key=lambda k: -k[1])
    busy_s = sum(us for _, us, _ in kernels) * 1e-6
    by = lambda tag: sum(us for n, us, _ in kernels if tag in n) * 1e-6
    report = engine.rounds[-1]
    print("diffusion_serve_profile", json.dumps({
        "round": SERVE_PROFILED_ROUND, "warmup_lanes": report.warmup_lanes,
        "adaptive_lanes": report.adaptive_lanes, "wall_s": wall_s,
        "device_busy_s": busy_s,
        "device_idle_share": max(0.0, 1.0 - busy_s / wall_s),
        "k1_device_s": by("stale_kv_attention"),
        "k3_device_s": by("cfg_epilogue"),
        "top_kernels": [{"name": n[:120], "device_s": us * 1e-6, "calls": c}
                        for n, us, c in kernels[:top]]}), flush=True)


def serve_cross_device(dev):
    """tiny-dit.reduced() fp32 served on the card and on the CPU with the
    same traffic: images within 1e-3 relative, and the card's launches
    equal to its dispatch count."""
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiConfig, StadiPipeline
    from repro_torch.kernels import ops
    from repro_torch.serving import DiffusionServingEngine

    cfg, params, _, _ = tiny_setup()
    gen = torch.Generator(device="cpu").manual_seed(SEED + 6)
    xs = [torch.randn(1, cfg.latent_size, cfg.latent_size, cfg.channels,
                      generator=gen) for _ in SERVE_TRAFFIC]
    conds = [i % cfg.n_classes for i in range(len(xs))]
    config = StadiConfig.from_occupancies([0.0, 0.5], m_base=8, m_warmup=2)
    images = {}
    for d in ("cpu", dev):
        engine = DiffusionServingEngine(StadiPipeline(
            cfg, params, sampler.linear_schedule(1000), config, device=d),
            slots=SERVE_SLOTS)
        before = ops.launch_counts()
        reqs, _ = serve_drain(engine, xs, conds, SERVE_TRAFFIC)
        images[d] = [r.image.cpu() for r in reqs]
        launches = {k: n - before.get(k, 0)
                    for k, n in ops.launch_counts().items()
                    if n != before.get(k, 0)}
        expected = serve_expected_launches(engine.stats(), cfg.n_layers)
    rels = [((a - b).norm() / b.norm()).item()
            for a, b in zip(images[dev], images["cpu"])]
    print("diffusion_serve_cross_device", json.dumps({
        "rel_err": rels, "launches": launches, "expected": expected}),
        flush=True)
    check(launches == expected, f"tiny diffusion_serve: launches {launches}, "
          f"the dispatches need {expected}")
    check(max(rels) < 1e-3, f"tiny diffusion_serve card vs CPU: {rels}")


# ----------------------------------------------------------------------
# the frame axis: K1 and K2 over the 2N cross-frame context, and
# the video paths
# ----------------------------------------------------------------------

#: the context of a video frame f > 0: its own 4096 published rows and frame
#: f-1's. K1's (Nl, tok_start): frame-sequential's two patches, the warm-up
#: step over the context, the stadi_video plan's two columns, an unaligned
#: layout; K2's (Nl_max, tok_start, valid_tokens): the stadi_video plan's
#: two rank columns and the main path's rank layouts
CTX_N = 8192
K1_CTX_CASES = [(2304, 0), (1792, 2304), (4096, 0), (2048, 2048), (200, 72)]
K2_CTX_LAYOUTS = [(2048, 0, 2048), (2048, 2048, 2048), (2304, 0, 2304),
                  (2304, 2304, 1792)]
VIDEO_FRAMES = 4


def phase_ctx2n(ops, ref, layers, dev, peaks):
    """K1 and K2 over a video frame's 2N context, built as the path builds
    it (``torch.cat`` of the frame's own published K/V and the previous
    frame's), fp32 and bf16, K1 at batch 1 and at the guided batch 2, with
    the bars and planted faults of phases 3 and 6 plus the previous frame's
    half dropped (K1) and n_tokens of one frame (K2, a lost
    ``ctx_tokens``); times at bf16 against the bound and SDPA over the same
    context. Returns (K1's timed readings, K2's)."""
    F = torch.nn.functional
    gen = torch.Generator(device="cpu").manual_seed(SEED + 20)
    H, hd, half = 16, 72, CTX_N // 2
    k1_timed, k2_timed = [], []
    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 2):
            for Nl, tok in K1_CTX_CASES:
                if B == 2 and Nl not in (2304, 4096):
                    continue                 # the guided video's layouts
                q, kf, vf, own_k, own_v = k1_inputs(half, Nl, dtype, dev, gen,
                                                    B, H, hd)
                _, _, _, prev_k, prev_v = k1_inputs(half, 1, dtype, dev, gen,
                                                    B, H, hd)
                ks, vs = torch.cat([own_k, prev_k], 1), torch.cat([own_v, prev_v], 1)
                out = ops.stale_kv_attention(q, kf, vf, ks, vs, tok_start=tok)
                want = ref.stale_kv_attention_ref(q, kf, vf, ks, vs, tok)
                faults = k1_planted_faults(layers, ref, q, kf, vf, ks, vs, tok)
                faults["previous frame's half dropped"] = \
                    ref.stale_kv_attention_ref(q, kf, vf, own_k, own_v, tok)
                line = {"kernel": "stale_kv_attention", "batch": B,
                        "dtype": str(dtype), "N": CTX_N, "Nl": Nl,
                        "tok_start": tok}
                if dtype == torch.bfloat16 and Nl % 256 == 0 and (
                        B == 1 or Nl == 2304):
                    full_k, full_v = ks.clone(), vs.clone()
                    full_k[:, tok:tok + Nl] = kf
                    full_v[:, tok:tok + Nl] = vf
                    qt, kt, vt = (t.transpose(1, 2) for t in (q, full_k, full_v))
                    bound_ms, bound_by = k1_bound_ms(B, H, Nl, CTX_N, hd, dtype,
                                                     peaks)
                    line.update(
                        ms=time_ms(lambda: ops.stale_kv_attention(
                            q, kf, vf, ks, vs, tok_start=tok)),
                        plain_ms=time_ms(lambda: ref.stale_kv_attention_ref(
                            q, kf, vf, ks, vs, tok), reps=3),
                        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                            qt, kt, vt)),
                        bound_ms=bound_ms, bound_by=bound_by)
                check_with_faults("k1_ctx2n_check", out, want, faults, dtype, line)
                if "ms" in line:
                    k1_timed.append(line)
        for nl, tok, valid in K2_CTX_LAYOUTS:
            args = k2_inputs(dtype, dev, gen, 1, nl=nl, npad=CTX_N + nl)
            out = ops.stale_kv_attention_padded(*args, tok, valid,
                                                n_tokens=CTX_N)
            plain = ref.stale_kv_attention_padded_ref
            want = plain(*args, tok, valid, CTX_N)
            faults = k2_planted_faults(plain, args, tok, valid, CTX_N)
            faults["n_tokens of one frame"] = plain(*args, tok, valid, half)
            line = {"kernel": "stale_kv_attention_padded", "dtype": str(dtype),
                    "tok_start": tok, "valid_tokens": valid,
                    "n_tokens": CTX_N, "Nl_max": nl, "Npad": CTX_N + nl}
            if dtype == torch.bfloat16:
                bound_ms, bound_by = k2_bound_ms(1, tok, valid, dtype, peaks,
                                                 nl=nl, n=CTX_N)
                line.update(
                    ms=time_ms(lambda: ops.stale_kv_attention_padded(
                        *args, tok, valid, n_tokens=CTX_N)),
                    plain_ms=time_ms(lambda: plain(*args, tok, valid, CTX_N),
                                     reps=3),
                    library_ms=time_ms(k2_library_call(args, tok, valid,
                                                       CTX_N)),
                    bound_ms=bound_ms, bound_by=bound_by)
            check_with_faults("k2_ctx2n_check", out, want, faults, dtype, line)
            if "ms" in line:
                k2_timed.append(line)
    return k1_timed, k2_timed


def video_setup(dev):
    """sdxl_setup's model and class with a clip of VIDEO_FRAMES frames whose
    frame 0 is the main path's x_T (the rest from SEED + 21), and that
    x_T."""
    cfg, params, x_T, cond = sdxl_setup(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    rest = torch.randn(1, VIDEO_FRAMES - 1, *x_T.shape[1:], generator=gen,
                       device=dev).to(x_T.dtype)
    return cfg, params, torch.cat([x_T[:, None], rest], 1), cond, x_T


def video_configs():
    """(frame-sequential on the main path's cluster, the stadi_video plan on
    [0.0, 0.0, 0.5, 0.5] with two frame rows)."""
    from repro_torch.core.pipeline import StadiConfig

    seq = StadiConfig.from_occupancies([0.0, 0.5], m_base=16, m_warmup=4,
                                       planner="stadi", backend="emulated",
                                       exchange="sync", num_frames=VIDEO_FRAMES)
    video = StadiConfig.from_occupancies(
        [0.0, 0.0, 0.5, 0.5], m_base=16, m_warmup=4, planner="stadi_video",
        frame_groups=2, backend="emulated", exchange="sync",
        num_frames=VIDEO_FRAMES)
    return seq, video


def phase_frames(ops, dev):
    """The emulated video paths on sdxl-dit (4 frames): frame-sequential
    unguided (``frames_check``) and fused guided (``frames_guided_check``),
    each driven as in phase 9 (launches: the trace's evals once a frame),
    frame 0 bitwise the main path's image; the stadi_video plan
    (``stadi_video_check``), bitwise the frame-sequential executor on its
    plan (placement invariance); and the video serving lanes
    (``diffusion_serve_video``: three clips on 2 slots, each run whole in
    its round, the first bitwise its lone generate). Returns {label:
    launches}."""
    from repro_torch.core import frames as frames_lib
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiPipeline
    from repro_torch.serving import DiffusionServingEngine

    cfg, params, video, cond, x_T = video_setup(dev)
    seq, stadi_video = video_configs()
    sched = sampler.linear_schedule(1000)
    image = StadiPipeline(cfg, params, sched, dataclasses.replace(
        seq, num_frames=1), device=dev).generate(x_T, cond).image
    out = {}
    for label, config in (("frames_check", seq),
                          ("frames_guided_check", dataclasses.replace(
                              seq, cfg_scale=CFG_SCALE))):
        guided_image = None
        if config.cfg_scale:
            guided_image = StadiPipeline(cfg, params, sched, dataclasses.replace(
                config, num_frames=1), device=dev).generate(x_T, cond).image
        launches, img, seconds = drive_path(ops, label, cfg, params, video,
                                            cond, config, dev)
        frame0 = torch.equal(img[:, 0], image if guided_image is None
                             else guided_image)
        line = {"path": label, "frames": VIDEO_FRAMES, "seconds": seconds,
                "seconds_per_frame": seconds / VIDEO_FRAMES,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "launches": launches, "frame0_bitwise_image": frame0,
                "finite_frames": [bool(torch.isfinite(img[:, f].float()).all())
                                  for f in range(VIDEO_FRAMES)]}
        print(label, json.dumps(line), flush=True)
        check(frame0, f"{label}: frame 0 is not bitwise the image path's")
        out[label] = launches

    launches, vid, seconds = drive_path(ops, "stadi_video_check", cfg, params,
                                        video, cond, stadi_video, dev,
                                        profile=False)
    pipe = StadiPipeline(cfg, params, sched, stadi_video, device=dev)
    plan = pipe.plan()
    seq_vid = frames_lib.run_frames(
        pipe.params, cfg, sched, video, cond, plan.temporal, plan.patches,
        frames=frames_lib.FramePlan(VIDEO_FRAMES, (VIDEO_FRAMES,))).image
    invariant = torch.equal(vid, seq_vid)
    print("stadi_video_check", json.dumps({
        "plan": {"steps": plan.temporal.steps, "ratios": plan.temporal.ratios,
                 "patches": plan.patches, "frame_groups": list(plan.frames.groups),
                 "modeled_interval_cost": plan.modeled_interval_cost},
        "seconds": seconds, "launches": launches,
        "bitwise_frame_sequential_on_its_plan": invariant}), flush=True)
    check(invariant, "stadi_video: the video depends on the frame placement")
    out["stadi_video_check"] = launches

    engine = DiffusionServingEngine(pipe, slots=2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    clips = [video] + [torch.randn(video.shape, generator=gen, device=dev).to(
        video.dtype) for _ in range(2)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(c, int(cond[0])) for c in clips]
    engine.run_to_completion()
    drain_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    first = torch.equal(reqs[0].image, vid)
    expected = {k: 3 * n for k, n in out["stadi_video_check"].items()}
    print("diffusion_serve_video", json.dumps({
        "clips": len(clips), "frames": VIDEO_FRAMES, "slots": 2,
        "rounds": len(engine.rounds), "drain_s": drain_s,
        "clips_per_s": len(clips) / drain_s,
        "wall_latency_s": [r.wall_latency_s for r in reqs],
        "modeled_latency_s": [r.modeled_latency_s for r in reqs],
        "cost_model": engine.stats()["cost_model"], "launches": launches,
        "expected_launches": expected, "first_clip_bitwise_lone_generate": first}),
        flush=True)
    check(first, "diffusion_serve_video: the first clip is not bitwise its "
          "lone generate")
    check(launches == expected, f"diffusion_serve_video: launches {launches}, "
          f"three clips need {expected}")
    check(all(bool(torch.isfinite(r.image.float()).all()) for r in reqs),
          "diffusion_serve_video: a clip is not finite")
    out["diffusion_serve_video"] = launches
    return out


def frames_rank(ctx, config):
    """One rank of spmd_frames on sdxl-dit: a cold generate with the launch
    counters set to 0 just before it, then one with the collectives timed.
    Returns its seconds, launches, the owned frames' launches, peak memory,
    the collectives' seconds and the video."""
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiPipeline
    from repro_torch.kernels import ops

    cfg, params, video, cond, _ = video_setup(ctx.device)
    pipe = StadiPipeline(cfg, params, sampler.linear_schedule(1000), config,
                         device=ctx.device)
    torch.cuda.reset_peak_memory_stats(ctx.device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe.generate(video, cond)
    torch.cuda.synchronize(ctx.device)
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    _, timed_s, spent = timed_generate(pipe, video, cond, ctx.device)
    plan = res.plan
    W = len(plan.patches)
    g, w = divmod(ctx.rank, W)
    owned = plan.frames.groups[g]
    warm = sum(1 for e in res.trace.events if e.synchronous)
    patch = sum(e.substeps[w] for e in res.trace.events if not e.synchronous)
    return {"seconds": seconds, "timed_wall_s": timed_s, "collective_s": spent,
            "launches": launches, "owned_frames": owned,
            "expected": {"stale_kv_attention": cfg.n_layers * max(warm, 1) * owned,
                         "stale_kv_attention_padded": cfg.n_layers * patch * owned},
            "peak_gib": torch.cuda.max_memory_allocated(ctx.device) / 2**30,
            "video": res.image.float().cpu().numpy()}


def phase_spmd_frames(dev, dist_backend="gloo"):
    """spmd_frames on the stadi_video plan: 2 frame rows x 2 patch-worker
    columns (gloo ranks sharing the card, or NCCL a card a rank): each
    rank's K1 and K2 launches those of its row's frames, the video equal on
    every rank and against the emulated video on the card, the handoffs'
    and gathers' seconds per rank. Returns the per-rank results."""
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiPipeline
    from repro_torch.launch import ranks

    _, stadi_video = video_configs()
    cfg, params, video, cond, _ = video_setup(dev)
    emu = StadiPipeline(cfg, params, sampler.linear_schedule(1000), stadi_video,
                        device=dev).generate(video, cond).image.float().cpu().numpy()
    del params
    torch.cuda.empty_cache()
    config = dataclasses.replace(stadi_video, backend="spmd_frames")
    t0 = time.perf_counter()
    outs = ranks.spawn(frames_rank, 4, device_type="cuda",
                       dist_backend=dist_backend, args=(config,),
                       timeout=900 if dist_backend == "gloo" else 300)
    rels = [float(np.linalg.norm(o["video"] - emu) / np.linalg.norm(emu))
            for o in outs]
    bitwise = [bool(np.array_equal(o["video"], emu)) for o in outs]
    print("spmd_frames_check", json.dumps({
        "ranks": 4, "dist_backend": dist_backend,
        "note": ("ranks share one card, gloo transport, not a makespan"
                 if dist_backend == "gloo" else "one card per rank, NCCL"),
        "phase_s": time.perf_counter() - t0,
        "seconds_per_rank": [o["seconds"] for o in outs],
        "timed_wall_s": [o["timed_wall_s"] for o in outs],
        "handoff_s": [o["collective_s"]["stage_handoff"] for o in outs],
        "gather_s": [o["collective_s"]["uneven_all_gather_padded"] for o in outs],
        "peak_gib_per_rank": [o["peak_gib"] for o in outs],
        "owned_frames": [o["owned_frames"] for o in outs],
        "launches_per_rank": [o["launches"] for o in outs],
        "expected_per_rank": [o["expected"] for o in outs],
        "rel_err_vs_emulated": rels, "bitwise_emulated": bitwise}), flush=True)
    for r, o in enumerate(outs):
        check(bool(np.isfinite(o["video"]).all()), f"spmd_frames: rank {r} "
              "video not finite")
        check(o["launches"] == o["expected"], f"spmd_frames: rank {r} launches "
              f"{o['launches']}, its frames need {o['expected']}")
        check(np.array_equal(o["video"], outs[0]["video"]),
              f"spmd_frames: rank {r} returned another video than rank 0")
    check(max(rels) < 1e-2, f"spmd_frames vs emulated {rels} (bar 1e-2)")
    return outs


# ----------------------------------------------------------------------
# prompt conditioning: the frozen text encoder and the DiT's prompt
# cross-attention on sdxl-dit .text_conditioned(32)
# ----------------------------------------------------------------------

PROMPT_SEQ_LEN = 32
#: the main path's prompt (7 words: bucket 8), another of its length, and
#: a shorter one (bucket 4). The stand-in tower's tokens are mostly its
#: sinusoidal positions (the hash-token embedding is drawn at std 0.02), so
#: prompts of one length steer the image apart far less than lengths do
PROMPT = "a red fox in the deep snow"
PROMPT_OTHER = "a blue whale singing under the ice"
PROMPT_SHORT = "whale song"
#: diffusion_serve_prompt traffic on 4 slots: (cfg_scale, round it is
#: submitted before, prompt). Buckets 8, 8, 4 (guided) and 32 at round 0,
#: then 4 (guided) and 32, queued until the first wave retires
PROMPT_TRAFFIC = [
    (None, 0, PROMPT),
    (None, 0, "an old lighthouse on a rocky shore"),
    (3.0, 0, "fox at dusk"),
    (None, 0, "a quiet mountain village at dawn with mist over the river "
              "and smoke rising from the chimneys of small stone houses"),
    (5.0, 3, "whale song"),
    (None, 3, "a crowded night market in the rain with neon signs reflected "
              "in puddles and people holding umbrellas of every color"),
]
PROMPT_BUCKETS = [8, 8, 4, 32, 4, 32]
#: the prompt read's helpers in models/diffusion/dit.py that the profile
#: wraps in record_function ranges
PROMPT_RANGES = ("_prompt_kv", "_prompt_read")


def prompt_setup(dev):
    """sdxl-dit .text_conditioned(PROMPT_SEQ_LEN) with weights from SEED
    (its class leaves bitwise sdxl_setup's, the cross-attention leaves from
    their own stream), the main path's x_T, and PROMPT's tokens from the
    port's frozen tower on ``dev``."""
    from repro_torch.configs import get_config
    from repro_torch.models import text_encoder
    from repro_torch.models.diffusion import dit

    cfg = get_config("sdxl-dit").text_conditioned(cond_seq_len=PROMPT_SEQ_LEN)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = dit.nondegenerate_params(dit.init_params(gen, cfg), gen)
    return (cfg, params, main_x_T(cfg, dev),
            text_encoder.encode([PROMPT], cfg, device=dev))


def profile_prompt(pipe, x_T, wall_s, top=12):
    """One encode of PROMPT and one generate on its tokens under
    torch.profiler, the prompt read's helpers (PROMPT_RANGES) and the
    encode in record_function ranges: the device time of the tower, of the
    prompt K/V projection and of the cross-attention read (each range's
    kernels), the device busy time by kernel, and the generate's idle share
    against the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import text_encoder
    from repro_torch.models.diffusion import dit

    originals = {name: getattr(dit, name) for name in PROMPT_RANGES}

    def ranged(name):
        def call(*args, **kw):
            with record_function(name):
                return originals[name](*args, **kw)
        return call
    for name in PROMPT_RANGES:
        setattr(dit, name, ranged(name))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("text_encoder.encode"):
                tok = text_encoder.encode([PROMPT], pipe.model_cfg,
                                          device=pipe.device)
            pipe.generate(x_T, tok)
            torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(dit, name, fn)
    cpu = torch.autograd.DeviceType.CPU
    events = prof.events()

    def range_s(name):
        return sum(e.device_time_total for e in events
                   if e.name == name and e.device_type == cpu) * 1e-6
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        # the ranges also show on the device's timeline, spanning their
        # kernels and the gaps between them: they are no kernels
        if (dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.key not in PROMPT_RANGES + ("text_encoder.encode",)):
            kernels.append((ev.key, dev_us, ev.count))
    kernels.sort(key=lambda k: -k[1])
    tower_s = range_s("text_encoder.encode")
    busy_s = sum(us for _, us, _ in kernels) * 1e-6 - tower_s
    line = {"wall_s": wall_s, "device_busy_s": busy_s,
            "device_idle_share": max(0.0, 1.0 - busy_s / wall_s),
            "tower_device_s": tower_s,
            "prompt_kv_device_s": range_s("_prompt_kv"),
            "cross_attention_device_s": range_s("_prompt_read"),
            "k1_device_s": sum(us for n, us, _ in kernels
                               if "stale_kv_attention" in n) * 1e-6,
            "kernel_launches": sum(c for _, _, c in kernels),
            "top_kernels": [{"name": n[:120], "device_s": us * 1e-6,
                             "calls": c} for n, us, c in kernels[:top]]}
    print("prompt_profile", json.dumps(line), flush=True)
    return line


def phase_prompt(ops, dev, class_launches):
    """The prompt paths on sdxl-dit .text_conditioned(32), bf16: the main
    path's plan on PROMPT (``prompt_check``: launches the class path's,
    seconds beside the class path's in this call, other prompts steer the
    image apart (a shorter one by more than 1e-2), class ids under the text
    config bitwise the class path, the tower's time, a profile); fused
    guidance (``prompt_guided_check``: K3 as the class guided path, the
    fused null branch bitwise an explicit null_cond
    forward, one block's read of the null sequence exactly 0.0); a 2-frame
    guided video on the stadi_video plan (``prompt_video_check``: frame 0
    bitwise the guided image on its schedule); and six prompt requests of
    buckets 4, 8 and 32 on 4 slots (``diffusion_serve_prompt``: each image
    bitwise its lone generate). Returns {label: launches}."""
    from repro_torch.core import patch_parallel as pp
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiConfig, StadiPipeline
    from repro_torch.models import text_encoder
    from repro_torch.models.diffusion import dit
    from repro_torch.serving import DiffusionServingEngine

    cfg, params, x_T, tok = prompt_setup(dev)
    ccfg, cparams, _, cond = sdxl_setup(dev)
    sched = sampler.linear_schedule(1000)
    main = StadiConfig.from_occupancies([0.0, 0.5], m_base=16, m_warmup=4,
                                        planner="stadi", backend="emulated",
                                        exchange="sync")
    leaves = all(torch.equal(v, params[k]) for k, v in cparams.items()
                 if k != "blocks") and all(
        torch.equal(v, params["blocks"][k]) for k, v in cparams["blocks"].items())
    class_res, class_s = timed_pipe_generate(
        StadiPipeline(ccfg, cparams, sched, main, device=dev), x_T, cond)
    del cparams
    torch.cuda.empty_cache()
    pipe = StadiPipeline(cfg, params, sched, main, device=dev)
    class_ids = torch.equal(pipe.generate(x_T, cond).image, class_res.image)
    tower_ms = time_ms(lambda: text_encoder.encode([PROMPT], cfg, device=dev))
    launches, img, seconds = drive_path(ops, "prompt_check", cfg, params, x_T,
                                        tok, main, dev, profile=False)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steer, steer_len = (rel_err(pipe.generate(x_T, text_encoder.encode(
        [p], cfg, device=dev)).image, img) for p in (PROMPT_OTHER, PROMPT_SHORT))
    prof = profile_prompt(pipe, x_T, seconds)
    print("prompt_check", json.dumps({
        "prompt": PROMPT, "bucket": tok.shape[1], "seconds": seconds,
        "class_seconds": class_s, "ratio_to_class": seconds / class_s,
        "launches": launches, "class_launches": class_launches["main_path"],
        "finite": bool(torch.isfinite(img.float()).all()),
        "rel_diff_other_prompt": steer, "rel_diff_short_prompt": steer_len,
        "class_leaves_bitwise": leaves, "class_ids_bitwise_class_path": class_ids,
        "tower_ms": tower_ms, "tower_device_s": prof["tower_device_s"],
        "cross_attention_device_s": prof["cross_attention_device_s"],
        "prompt_kv_device_s": prof["prompt_kv_device_s"],
        "device_idle_share": prof["device_idle_share"],
        "peak_gib": peak_gib}), flush=True)
    check(tok.shape[1] == 8, f"prompt_check: bucket {tok.shape[1]}, not 8")
    check(launches == class_launches["main_path"],
          f"prompt_check: launches {launches}, the class path's "
          f"{class_launches['main_path']}")
    check(bool(torch.isfinite(img.float()).all()), "prompt_check: non-finite image")
    check(steer > 0 and steer_len > 1e-2, f"prompt_check: prompts steer the "
          f"image apart by {steer} (same bucket) and {steer_len} (bucket 4)")
    check(leaves, "prompt_check: the text config's class leaves differ")
    check(class_ids, "prompt_check: class ids under the text config are not "
          "bitwise the class path")

    guided = dataclasses.replace(main, cfg_scale=CFG_SCALE)
    g_launches, _, g_seconds = drive_path(ops, "prompt_guided_check", cfg,
                                          params, x_T, tok, guided, dev,
                                          profile=False)
    eps2, _ = dit.forward_patch_cfg(pipe.params, cfg, x_T, 500, tok, 0,
                                    return_kv=False)
    null = text_encoder.null_cond(1, tok.shape[1], cfg, device=dev)
    null_bitwise = torch.equal(eps2[1], dit.forward(pipe.params, cfg, x_T, 500,
                                                    null))
    h = torch.randn(1, 2304, cfg.d_model, device=dev).to(torch.bfloat16)
    blk = {k: v[0] for k, v in pipe.params["blocks"].items()}
    kv = dit._prompt_kv(pipe.params["blocks"]["xkv"][:1], null[..., :-1],
                        h.dtype)[0]
    null_read = dit._prompt_read(blk, h, kv, (null[..., -1] > 0.5)[
        :, None, None, :], cfg.n_heads)
    null_zero = torch.equal(null_read, h)
    print("prompt_guided_check", json.dumps({
        "cfg_scale": CFG_SCALE, "seconds": g_seconds, "launches": g_launches,
        "class_launches": class_launches["guided_fused"],
        "fused_null_bitwise_explicit_null": null_bitwise,
        "null_read_exactly_zero_bf16": null_zero}), flush=True)
    check(g_launches == class_launches["guided_fused"],
          f"prompt_guided_check: launches {g_launches}, the class guided "
          f"path's {class_launches['guided_fused']}")
    check(null_bitwise, "prompt_guided_check: the fused null branch is not "
          "bitwise an explicit null_cond forward")
    check(null_zero, "prompt_guided_check: the read of the null sequence "
          "is not exactly 0.0")

    video_cfg = StadiConfig.from_occupancies(
        [0.0, 0.0, 0.5, 0.5], m_base=16, m_warmup=4, planner="stadi_video",
        num_frames=2, guidance="fused", cfg_scale=CFG_SCALE,
        backend="emulated", exchange="sync")
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    clip = torch.cat([x_T[:, None], torch.randn(
        1, 1, *x_T.shape[1:], generator=gen, device=dev).to(x_T.dtype)], 1)
    v_launches, vid, v_seconds = drive_path(ops, "prompt_video_check", cfg,
                                            params, clip, tok, video_cfg, dev,
                                            profile=False)
    plan = StadiPipeline(cfg, params, sched, video_cfg, device=dev).plan()
    image = pp.run_schedule(pipe.params, cfg, sched, x_T, tok, plan.temporal,
                            plan.patches, guidance=plan.guidance).image
    frame0 = torch.equal(vid[:, 0], image)
    print("prompt_video_check", json.dumps({
        "frames": 2, "plan": {"steps": plan.temporal.steps,
                              "patches": plan.patches,
                              "frame_groups": list(plan.frames.groups),
                              "guidance": plan.guidance.mode},
        "seconds": v_seconds, "launches": v_launches,
        "frame0_bitwise_guided_image": frame0}), flush=True)
    check(frame0, "prompt_video_check: frame 0 is not bitwise the guided "
          "image on its schedule")

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    xs = [torch.randn(1, cfg.latent_size, cfg.latent_size, cfg.channels,
                      generator=gen, device=dev).to(torch.bfloat16)
          for _ in PROMPT_TRAFFIC]
    toks = [text_encoder.encode([p], cfg, device=dev)
            for _, _, p in PROMPT_TRAFFIC]
    traffic = [(scale, at) for scale, at, _ in PROMPT_TRAFFIC]
    check([t.shape[1] for t in toks] == PROMPT_BUCKETS,
          f"diffusion_serve_prompt: buckets {[t.shape[1] for t in toks]}")
    serve_drain(DiffusionServingEngine(pipe, slots=SERVE_SLOTS), xs, toks,
                traffic)
    torch.cuda.synchronize()
    engine = DiffusionServingEngine(pipe, slots=SERVE_SLOTS)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs, walls = serve_drain(engine, xs, toks, traffic, sync=True)
    drain_s = time.perf_counter() - t0
    s_launches = ops.launch_counts()
    stats = engine.stats()
    expected = serve_expected_launches(stats, cfg.n_layers)
    bitwise = [torch.equal(req.image, StadiPipeline(
        cfg, params, sched, dataclasses.replace(main, cfg_scale=scale or 0.0),
        device=dev).generate(xs[i], toks[i]).image)
        for i, (req, (scale, _)) in enumerate(zip(reqs, traffic))]
    print("diffusion_serve_prompt", json.dumps({
        "slots": SERVE_SLOTS, "traffic": traffic, "buckets": PROMPT_BUCKETS,
        "drain_s": drain_s, "images_per_s": len(reqs) / drain_s,
        "rounds": len(engine.rounds), "round_walls_s": walls,
        "dispatches": stats["dispatches"],
        "dispatches_by_bucket": stats["dispatches_by_bucket"],
        "launches": s_launches, "expected_launches": expected,
        "bitwise_vs_generate": bitwise,
        "wall_latency_s": [r.wall_latency_s for r in reqs]}), flush=True)
    check(s_launches == expected and all(expected.values()),
          f"diffusion_serve_prompt: launches {s_launches}, the dispatches "
          f"need {expected}")
    check(all(bitwise), f"diffusion_serve_prompt: served images not bitwise "
          f"their lone generate: {bitwise}")
    return {"prompt_check": launches, "prompt_guided_check": g_launches,
            "prompt_video_check": v_launches,
            "diffusion_serve_prompt": s_launches}


def phase_cross_device(dev):
    """tiny-dit.reduced() in fp32 on the card and on the CPU: unguided,
    guided fused and guided interleaved; and tiny-dit.reduced()
    .text_conditioned(8) on two prompts, unguided and guided fused, after
    the frozen tower itself (card against CPU within 1e-4)."""
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiConfig, StadiPipeline
    from repro_torch.models import text_encoder
    from repro_torch.models.diffusion import dit

    cfg, params, x_T, cond = tiny_setup()
    tcfg = cfg.text_conditioned(cond_seq_len=8)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    tparams = dit.nondegenerate_params(dit.init_params(gen, tcfg), gen)
    prompts = ["a red fox", "blue whale song under the ice"]
    tok = text_encoder.encode(prompts, tcfg, device="cpu")
    tower_err = (text_encoder.encode(prompts, tcfg, device=dev).cpu()
                 - tok).abs().max().item()
    print(f"cross_device text encoder (cond_dim {tcfg.cond_dim}, bucket "
          f"{tok.shape[1]}): card vs CPU max abs error {tower_err:.3e} "
          "(bar 1e-4)", flush=True)
    check(tower_err < 1e-4, f"the tower on the card differs from the CPU's: "
          f"{tower_err}")
    unguided = StadiConfig.from_occupancies([0.0, 0.5], m_base=8, m_warmup=2)
    fused = dataclasses.replace(unguided, cfg_scale=CFG_SCALE)
    runs = {
        "unguided": (cfg, params, cond, unguided),
        "guided_fused": (cfg, params, cond, fused),
        "guided_interleaved": (cfg, params, cond, StadiConfig.from_occupancies(
            [0.0, 0.0, 0.5, 0.5], m_base=16, m_warmup=4, cfg_scale=CFG_SCALE,
            planner="stadi_guidance", guidance="interleaved")),
        "prompt": (tcfg, tparams, tok, unguided),
        "prompt_guided_fused": (tcfg, tparams, tok, fused),
    }
    rels = {}
    for label, (model_cfg, weights, c, config) in runs.items():
        images = {d: StadiPipeline(model_cfg, weights,
                                   sampler.linear_schedule(1000), config,
                                   device=d).generate(x_T, c).image.cpu()
                  for d in ("cpu", dev)}
        rel = ((images[dev] - images["cpu"]).norm() / images["cpu"].norm()).item()
        print(f"cross_device tiny-dit.reduced fp32 {label}: card vs CPU "
              f"relative error {rel:.3e} (bar 1e-3)", flush=True)
        check(rel < 1e-3, f"{label}: card image differs from the CPU image: {rel}")
        rels[label] = rel
    return rels


# ----------------------------------------------------------------------
# the displaced stage chain and the multi-rank serving lanes
# ----------------------------------------------------------------------

CHAIN_STAGES = 2
#: SERVE_TRAFFIC with every request unguided: the pipefuse stepper at two
#: stages and the spmd stepper serve no guided lane
SERVE_TRAFFIC_UNGUIDED = [(None, at) for _, at in SERVE_TRAFFIC]


def chain_config(**kw):
    """The main path's cluster and schedule with ``kw`` on top."""
    from repro_torch.core.pipeline import StadiConfig
    return StadiConfig.from_occupancies([0.0, 0.5], m_base=16, m_warmup=4,
                                        planner="stadi", exchange="sync", **kw)


def rel_err(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def timed_pipe_generate(pipe, x_T, cond):
    """A warm-up generate, then one timed: (the result, its seconds)."""
    pipe.generate(x_T, cond)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipe.generate(x_T, cond)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_pipefuse(ops, dev):
    """The displaced stage chain (backend pipefuse) on sdxl-dit at full
    width: at one stage the image is bitwise the emulated one; at two
    stages, unguided and guided fused, each path is driven like the main
    path (launches against its trace: K1 once a layer of every eval, K3
    once a guided eval, with its delta), and its relative difference from
    the emulated image (the displaced contract's drift) and its seconds
    beside the emulated generate's are printed; the unguided path is
    profiled. The guided chain is held against its drift: the same chain
    with K3's plain version in place of the kernel must come within a tenth
    of that drift. Returns {label: launches}."""
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiPipeline
    from repro_torch.kernels import ref

    cfg, params, x_T, cond = sdxl_setup(dev)
    sched = sampler.linear_schedule(1000)
    emulated = {scale: timed_pipe_generate(StadiPipeline(
        cfg, params, sched, chain_config(backend="emulated", cfg_scale=scale),
        device=dev), x_T, cond) for scale in (0.0, CFG_SCALE)}
    one = StadiPipeline(cfg, params, sched, chain_config(backend="pipefuse"),
                        device=dev).generate(x_T, cond)
    bitwise = torch.equal(one.image, emulated[0.0][0].image)
    print("pipefuse_one_stage", json.dumps({
        "stages": one.trace.stages, "bitwise_emulated": bitwise}), flush=True)
    check(bitwise, "pipefuse at one stage is not bitwise the emulated image")
    launches = {}
    for label, scale in (("pipefuse", 0.0), ("pipefuse_guided", CFG_SCALE)):
        config = chain_config(backend="pipefuse", num_stages=CHAIN_STAGES,
                              cfg_scale=scale)
        launches[label], img, seconds = drive_path(
            ops, label, cfg, params, x_T, cond, config, dev,
            profile=scale == 0.0)
        emu, emu_s = emulated[scale]
        drift = rel_err(img, emu.image)
        line = {"path": label, "stages": StadiPipeline(
                    cfg, params, sched, config, device=dev).plan().stages,
                "seconds": seconds, "emulated_seconds": emu_s,
                "rel_diff_vs_emulated": drift,
                "note": "the displaced contract: contexts one substep "
                        "fresher than the emulated engine's published "
                        "buffers"}
        if scale:
            kernel = ops.cfg_epilogue
            ops.cfg_epilogue = lambda c, u, w, *, with_delta=True: (
                ref.cfg_epilogue_ref(c, u, w) if with_delta
                else ref.cfg_epilogue_ref(c, u, w)[0])
            try:
                plain = StadiPipeline(cfg, params, sched, config,
                                      device=dev).generate(x_T, cond).image
            finally:
                ops.cfg_epilogue = kernel
            line["rel_diff_vs_plain_k3_chain"] = rel_err(img, plain)
            line["bar"] = "a tenth of rel_diff_vs_emulated"
        print("pipefuse_check", json.dumps(line), flush=True)
        check(0.0 < drift < 1e-2, f"{label}: the chain is {drift} off the "
              "emulated image (a displaced chain moves it, by less than 1e-2)")
        if scale:
            check(line["rel_diff_vs_plain_k3_chain"] < 0.1 * drift,
                  f"{label}: {line['rel_diff_vs_plain_k3_chain']} off the "
                  f"chain with K3's plain version, drift {drift}")
    return launches


def phase_diffusion_serve_pipefuse(ops, dev):
    """The pipefuse serving lanes: sdxl-dit at full width, two stages, 4
    slots, SERVE_TRAFFIC's six requests at their rounds, every one
    unguided: a warm-up drain, then the measured drain with the launch
    counters set to 0 just before it (K1 once a layer of every denoiser
    dispatch); each image bitwise its lone pipefuse generate (the relative
    errors printed too); the drain's seconds and images per second.
    Returns the measured drain's launches."""
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiPipeline
    from repro_torch.serving import DiffusionServingEngine

    cfg, params, _, _ = sdxl_setup(dev)
    pipe = StadiPipeline(cfg, params, sampler.linear_schedule(1000),
                         chain_config(backend="pipefuse",
                                      num_stages=CHAIN_STAGES), device=dev)
    xs, conds = serve_inputs(cfg, dev)
    t0 = time.perf_counter()
    serve_drain(DiffusionServingEngine(pipe, slots=SERVE_SLOTS), xs, conds,
                SERVE_TRAFFIC_UNGUIDED)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    engine = DiffusionServingEngine(pipe, slots=SERVE_SLOTS)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs, walls = serve_drain(engine, xs, conds, SERVE_TRAFFIC_UNGUIDED,
                              sync=True)
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    stats = engine.stats()
    expected = {k: n for k, n in serve_expected_launches(
        stats, cfg.n_layers).items() if n}
    lone = [pipe.generate(xs[i], torch.tensor([conds[i]], device=dev)).image
            for i in range(len(reqs))]
    rels = [rel_err(r.image, w) for r, w in zip(reqs, lone)]
    print("diffusion_serve_pipefuse", json.dumps({
        "slots": SERVE_SLOTS, "traffic": SERVE_TRAFFIC_UNGUIDED,
        "stages": engine.stages, "drain_s": seconds, "first_drain_s": first_s,
        "images_per_s": len(reqs) / seconds, "rounds": len(engine.rounds),
        "round_walls_s": walls, "placements": sorted({
            str(r.placement) for r in engine.rounds if r.placement}),
        "dispatches": stats["dispatches"], "launches": launches,
        "expected_launches": expected,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "rel_err_vs_generate": rels,
        "bitwise_vs_generate": [torch.equal(r.image, w)
                                for r, w in zip(reqs, lone)]}), flush=True)
    check(all(r.done and bool(torch.isfinite(r.image.float()).all())
              for r in reqs), "diffusion_serve_pipefuse: a request did not "
          "finish finite")
    check(launches == expected and expected,
          f"diffusion_serve_pipefuse: launches {launches}, the dispatches "
          f"need {expected}")
    check(all(torch.equal(r.image, w) for r, w in zip(reqs, lone)),
          f"diffusion_serve_pipefuse: served images not bitwise their lone "
          f"generate (relative errors {rels})")
    return launches


def chain_rank(ctx, jobs):
    """One rank of the multi-rank chain phase. ``spmd_pipefuse``: a warm-up
    generate, then one with the launch counters set to 0 just before it;
    launches against its trace (K1 once a layer of each full-depth warm-up
    forward, once per block of this rank's stage of each micro-task); then
    one more with the handoffs and broadcasts timed (``timed_generate``). ``diffusion_serve_spmd``: a warm-up
    drain of the unguided traffic, then the measured drain (K1 once a
    layer of each warm-up dispatch, K2 once a layer of each of this rank's
    padded forwards). Returns per job its numbers and images."""
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiPipeline
    from repro_torch.kernels import ops
    from repro_torch.serving import DiffusionServingEngine

    dev = ctx.device
    cfg, params, x_T, cond = sdxl_setup(dev)
    sched = sampler.linear_schedule(1000)
    out = {}
    if "spmd_pipefuse" in jobs:
        pipe = StadiPipeline(cfg, params, sched, chain_config(
            backend="spmd_pipefuse", num_stages=CHAIN_STAGES), device=dev)
        pipe.generate(x_T, cond)                 # warm-up (cuBLAS, NCCL p2p)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = pipe.generate(x_T, cond)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
        _, timed_s, spent = timed_generate(pipe, x_T, cond, dev)
        trace = res.trace
        warm = sum(1 for e in trace.events if e.synchronous)
        micro = sum(sum(e.substeps) for e in trace.events if not e.synchronous)
        out["spmd_pipefuse"] = {
            "seconds": seconds, "launches": launches,
            "expected": {"stale_kv_attention": cfg.n_layers * max(warm, 1)
                         + trace.stages[ctx.rank] * micro},
            "stages": trace.stages, "micro_tasks": micro,
            "chain_timed_run": {"wall_s": timed_s, "handoff_s": spent[
                "stage_handoff"], "broadcast_s": spent["chain_broadcast"]},
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "image": res.image.float().cpu().numpy()}
        del pipe, res
    if "diffusion_serve_spmd" in jobs:
        pipe = StadiPipeline(cfg, params, sched, chain_config(backend="spmd"),
                             device=dev)
        xs, conds = serve_inputs(cfg, dev)
        serve_drain(DiffusionServingEngine(pipe, slots=SERVE_SLOTS), xs,
                    conds, SERVE_TRAFFIC_UNGUIDED)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        engine = DiffusionServingEngine(pipe, slots=SERVE_SLOTS)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        reqs, walls = serve_drain(engine, xs, conds, SERVE_TRAFFIC_UNGUIDED,
                                  sync=True)
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
        d = engine.stats()["dispatches"]
        out["diffusion_serve_spmd"] = {
            "seconds": seconds, "launches": launches, "dispatches": d,
            "expected": {"stale_kv_attention": cfg.n_layers * (
                d.get("plain", 0) + d.get("bootstrap", 0)),
                "stale_kv_attention_padded": cfg.n_layers * d["padded"]},
            "rounds": len(engine.rounds), "round_walls_s": walls,
            "cohorts": [r.exchange_kinds for r in engine.rounds],
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "images": [r.image.float().cpu().numpy() for r in reqs]}
    return out


def phase_chain_ranks(dev, dist_backend="gloo"):
    """The multi-rank paths of this slice on 2 ranks (gloo ranks sharing the
    card, or with NCCL a card each): ``spmd_pipefuse`` (ranks = stages)
    bitwise the emulated pipefuse image on the card, and the spmd serving
    lanes (``diffusion_serve_spmd``, the unguided SERVE_TRAFFIC on 4 slots)
    with each image bitwise its lone emulated generate;
    each rank's launches equal to what its trace or dispatches need; per
    rank its peak memory, and for the chain its handoff and broadcast
    seconds. Returns ({label: launches summed over the ranks}, {label:
    seconds per rank})."""
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiPipeline
    from repro_torch.launch import ranks

    cfg, params, x_T, cond = sdxl_setup(dev)
    sched = sampler.linear_schedule(1000)
    chain_ref = StadiPipeline(cfg, params, sched, chain_config(
        backend="pipefuse", num_stages=CHAIN_STAGES), device=dev).generate(
            x_T, cond).image.float().cpu().numpy()
    emu = StadiPipeline(cfg, params, sched, chain_config(backend="emulated"),
                        device=dev)
    xs, conds = serve_inputs(cfg, dev)
    lone = [emu.generate(x, torch.tensor([c], device=dev)).image.float().cpu()
            .numpy() for x, c in zip(xs, conds)]
    del params, emu
    torch.cuda.empty_cache()
    shared = dist_backend == "gloo"
    t0 = time.perf_counter()
    per_rank = ranks.spawn(chain_rank, 2, device_type="cuda",
                           dist_backend=dist_backend,
                           args=(("spmd_pipefuse", "diffusion_serve_spmd"),),
                           timeout=900 if shared else 300)
    note = ("ranks share one card, gloo transport, not a makespan" if shared
            else "one card per rank, NCCL")
    print(f"chain ranks: 2 {dist_backend} ranks ran spmd_pipefuse and "
          f"diffusion_serve_spmd in {time.perf_counter() - t0:.1f} s (process "
          "start included)", flush=True)
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    launches, seconds = {}, {}
    outs = [r["spmd_pipefuse"] for r in per_rank]
    rels = [rel(o["image"], chain_ref) for o in outs]
    print("spmd_pipefuse_check", json.dumps({
        "ranks": 2, "stages": outs[0]["stages"],
        "micro_tasks": outs[0]["micro_tasks"],
        "seconds_per_rank": [o["seconds"] for o in outs], "seconds_note": note,
        "peak_gib_per_rank": [o["peak_gib"] for o in outs],
        "chain_comm_per_rank": [o["chain_timed_run"] for o in outs],
        "launches_per_rank": [o["launches"] for o in outs],
        "expected_per_rank": [o["expected"] for o in outs],
        "rel_err_vs_emulated_pipefuse": rels, "bar": "bitwise"}), flush=True)
    for r, o in enumerate(outs):
        check(bool(np.isfinite(o["image"]).all()),
              f"spmd_pipefuse: rank {r} image not finite")
        check(o["launches"] == o["expected"], f"spmd_pipefuse: rank {r} "
              f"launches {o['launches']}, the trace needs {o['expected']}")
        check(np.array_equal(o["image"], outs[0]["image"]),
              f"spmd_pipefuse: rank {r} returned another image than rank 0")
    check(all(np.array_equal(o["image"], chain_ref) for o in outs),
          f"spmd_pipefuse not bitwise the emulated pipefuse image: {rels}")
    launches["spmd_pipefuse"] = outs
    seconds["spmd_pipefuse"] = [o["seconds"] for o in outs]
    outs = [r["diffusion_serve_spmd"] for r in per_rank]
    rels = [[rel(img, want) for img, want in zip(o["images"], lone)]
            for o in outs]
    print("diffusion_serve_spmd", json.dumps({
        "ranks": 2, "slots": SERVE_SLOTS, "traffic": SERVE_TRAFFIC_UNGUIDED,
        "drain_s_per_rank": [o["seconds"] for o in outs],
        "images_per_s": [len(lone) / o["seconds"] for o in outs],
        "seconds_note": note, "rounds": outs[0]["rounds"],
        "round_walls_s_rank0": outs[0]["round_walls_s"],
        "exchange_kinds_per_round": outs[0]["cohorts"],
        "peak_gib_per_rank": [o["peak_gib"] for o in outs],
        "dispatches_per_rank": [o["dispatches"] for o in outs],
        "launches_per_rank": [o["launches"] for o in outs],
        "expected_per_rank": [o["expected"] for o in outs],
        "rel_err_vs_generate_per_rank": rels, "bar": "bitwise"}), flush=True)
    for r, o in enumerate(outs):
        check(all(np.isfinite(img).all() for img in o["images"]),
              f"diffusion_serve_spmd: rank {r} image not finite")
        check(o["launches"] == o["expected"], f"diffusion_serve_spmd: rank "
              f"{r} launches {o['launches']}, its dispatches need "
              f"{o['expected']}")
        check(all(np.array_equal(img, want)
                  for img, want in zip(o["images"], lone)),
              f"diffusion_serve_spmd: rank {r} images not bitwise their lone "
              f"generate (relative errors {rels[r]})")
    launches["diffusion_serve_spmd"] = outs
    seconds["diffusion_serve_spmd"] = [o["seconds"] for o in outs]
    summed = {}
    for label, outs in launches.items():
        summed[label] = {}
        for o in outs:
            for kernel, n in o["launches"].items():
                summed[label][kernel] = summed[label].get(kernel, 0) + n
    return summed, seconds


def spmd_paths():
    """The multi-rank paths: label -> (model, ranks, config). sdxl-dit at
    full width on the main path's cluster (unguided and fused guidance, 2
    ranks; on PROMPT with the text-conditioned model, 2 ranks;
    sequence-parallel at seq_shards 2, 2 x 2 ranks) and the split
    placement (4 ranks); tiny-dit.reduced() in fp32 under each exchange
    kind and placement the card-vs-CPU check covers."""
    from repro_torch.core.pipeline import StadiConfig

    occ = StadiConfig.from_occupancies
    main = occ([0.0, 0.5], m_base=16, m_warmup=4, planner="stadi",
               backend="spmd", exchange="sync")
    split = occ([0.0, 0.0, 0.5, 0.5], m_base=16, m_warmup=4,
                cfg_scale=CFG_SCALE, planner="stadi_guidance",
                guidance="split", backend="spmd_guidance")
    tiny = occ([0.0, 0.5], m_base=8, m_warmup=2, backend="spmd")
    seq = dataclasses.replace(main, seq_shards=2, exchange="ring",
                              backend="spmd_seq")
    return {
        "spmd": ("sdxl", 2, main),
        "spmd_prompt": ("sdxl_prompt", 2, main),
        "spmd_fused": ("sdxl", 2, dataclasses.replace(main, cfg_scale=CFG_SCALE)),
        "spmd_split": ("sdxl", 4, split),
        "tiny_spmd_sync": ("tiny", 2, tiny),
        "tiny_spmd_stale_async": ("tiny", 2, dataclasses.replace(
            tiny, exchange="stale_async")),
        "tiny_spmd_fused": ("tiny", 2, dataclasses.replace(tiny, cfg_scale=CFG_SCALE)),
        "tiny_spmd_split": ("tiny", 4, dataclasses.replace(
            split, m_base=8, m_warmup=2)),
        "spmd_seq": ("sdxl", 4, seq),
        "tiny_spmd_seq": ("tiny", 4, dataclasses.replace(
            seq, m_base=8, m_warmup=2)),
    }


def expected_rank_launches(result, n_layers, rank):
    """Launches one rank's generate must make, from its trace: K1 once per
    layer of each full-image warm-up forward (one bootstrap forward when
    there is no warm-up), and per layer of each of its patch worker's
    substeps (a rank skips its inactive substeps) K2 once, or on a
    seq-sharded trace K4 once per ring hop its records name (seq_hops + 1
    segments) and no K2; on fused guidance K3 once per eval that uses eps.
    Rank s * N + d is worker d's."""
    trace = result.trace
    idx = rank % len(trace.patches)
    warm = sum(1 for e in trace.events if e.synchronous)
    patch = sum(e.substeps[idx] for e in trace.events if not e.synchronous)
    expected = {"stale_kv_attention": n_layers * max(warm, 1)}
    if trace.seq is not None:
        expected["lse_attention"] = n_layers * sum(
            e.substeps[idx] * (e.seq_hops + 1)
            for e in trace.events if not e.synchronous)
    else:
        expected["stale_kv_attention_padded"] = n_layers * patch
    if trace.guidance is not None and trace.guidance.mode == "fused":
        expected["cfg_epilogue"] = warm + patch
    return expected


#: the collectives of core/comm.py that the multi-rank paths call
COLLECTIVES = ("uneven_all_gather_padded", "ulysses_scatter_heads",
               "ulysses_gather_heads", "ring_hop", "stage_handoff",
               "chain_broadcast")


def timed_generate(pipe, x_T, cond, device):
    """One generate with each collective of ``COLLECTIVES`` timed on the
    host, the card synchronised before and after it: (the result, wall
    seconds, seconds in each collective). A collective's time includes
    gloo's staging through host memory and the wait for the slowest rank to
    arrive; the synchronisations are in the wall time too."""
    from repro_torch.core import comm

    originals = {name: getattr(comm, name) for name in COLLECTIVES}
    spent = dict.fromkeys(COLLECTIVES, 0.0)

    def timed(name):
        def call(*args, **kw):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = originals[name](*args, **kw)
            torch.cuda.synchronize(device)
            spent[name] += time.perf_counter() - t0
            return out
        return call
    for name in COLLECTIVES:
        setattr(comm, name, timed(name))
    try:
        t0 = time.perf_counter()
        res = pipe.generate(x_T, cond)
        torch.cuda.synchronize(device)
        return res, time.perf_counter() - t0, spent
    finally:
        for name, fn in originals.items():
            setattr(comm, name, fn)


def model_setup(model, dev):
    """(cfg, params, x_T, cond) of a model of ``spmd_paths``."""
    return {"sdxl": sdxl_setup, "sdxl_prompt": prompt_setup,
            "tiny": lambda _: tiny_setup()}[model](dev)


def spmd_rank(ctx, jobs):
    """One rank of the spmd phase: for each job, an optional warm-up
    generate, then a generate with the launch counters set to 0 just before
    it and read just after, and on sdxl-dit one more with the collectives
    timed. Over gloo the sdxl-dit spmd_seq job, whose collectives take tens
    of seconds there, runs one generate only, cold and with its collectives
    timed. Returns per job its seconds, launches, the trace-derived
    launches, peak memory, collective times and image."""
    import torch.distributed as dist

    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiPipeline
    from repro_torch.kernels import ops

    models, out = {}, {}
    for label, model, config in jobs:
        if model not in models:
            models[model] = model_setup(model, ctx.device)
        cfg, params, x_T, cond = models[model]
        pipe = StadiPipeline(cfg, params, sampler.linear_schedule(1000), config,
                             device=ctx.device)
        sdxl = model.startswith("sdxl")
        single = (sdxl and config.backend == "spmd_seq"
                  and dist.get_backend() == "gloo")
        if sdxl and not single:                  # first call: cuBLAS warm-up
            pipe.generate(x_T, cond)
            torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if single:
            res, seconds, spent = timed_generate(pipe, x_T, cond, ctx.device)
        else:
            res = pipe.generate(x_T, cond)
            torch.cuda.synchronize(ctx.device)
            seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak_gib = torch.cuda.max_memory_allocated(ctx.device) / 2**30
        if sdxl and not single:
            _, timed_s, spent = timed_generate(pipe, x_T, cond, ctx.device)
        elif single:
            timed_s = seconds
        else:
            timed_s = spent = None
        out[label] = {"seconds": seconds, "launches": launches,
                      "expected": expected_rank_launches(res, cfg.n_layers, ctx.rank),
                      "kernel_stats": res.kernel_stats,
                      "peak_gib": peak_gib, "timed_wall_s": timed_s,
                      "collective_s": spent, "single_generate": single,
                      "patches": res.plan.patches,
                      "seq": None if res.plan.seq is None else [
                          list(res.plan.seq.heads), list(res.plan.seq.segments)],
                      "image": res.image.float().cpu().numpy()}
    return out


def phase_spmd(dev, dist_backend="gloo"):
    """The multi-rank paths: launches per rank equal to the trace's, finite
    images equal on every rank, sdxl-dit against the port's emulated image
    on the card (relative error < 1e-2, bf16 over 16 steps), tiny-dit fp32
    against the emulated image on the CPU (< 1e-3). With gloo the ranks
    share the card; with NCCL each rank has a card of its own (4 cards).
    Returns {label: per-rank results}."""
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiPipeline
    from repro_torch.launch import ranks

    paths = spmd_paths()
    refs = {}
    for model, device, bar in (("sdxl", dev, 1e-2), ("sdxl_prompt", dev, 1e-2),
                               ("tiny", "cpu", 1e-3)):
        cfg, params, x_T, cond = model_setup(model, dev)
        for label, (m, _, config) in paths.items():
            if m == model:
                emu = dataclasses.replace(config, backend="emulated")
                img = StadiPipeline(cfg, params, sampler.linear_schedule(1000), emu,
                                    device=device).generate(x_T, cond).image
                refs[label] = (img.float().cpu().numpy(), bar, device)
        del params
    torch.cuda.empty_cache()
    shared = dist_backend == "gloo"
    print(f"spmd transport: torch.distributed {dist_backend} collectives "
          "(all_gather, all_reduce) called on the CUDA tensors themselves"
          + ("; gloo stages them through host memory, comm.py adds no staging"
             if shared else "; one card per rank"), flush=True)
    results = {}
    for world in (2, 4):
        jobs = [(label, m, config) for label, (m, w, config) in paths.items()
                if w == world]
        t0 = time.perf_counter()
        per_rank = ranks.spawn(spmd_rank, world, device_type="cuda",
                               dist_backend=dist_backend, args=(jobs,),
                               timeout=900 if shared else 300)
        print(f"spmd phase: {world} {dist_backend} ranks on "
              f"{'one card' if shared else f'{world} cards'} ran "
              f"{[j[0] for j in jobs]} in {time.perf_counter() - t0:.1f} s "
              "(process start included)", flush=True)
        for label, _, _ in jobs:
            want, bar, ref_device = refs[label]
            outs = [r[label] for r in per_rank]
            rels = [float(np.linalg.norm(o["image"] - want) / np.linalg.norm(want))
                    for o in outs]
            note = ("ranks share one card, gloo transport, not a makespan"
                    if shared else "one card per rank, NCCL")
            if outs[0]["single_generate"]:
                note += ("; one cold generate (no warm-up call), its "
                         "collectives timed between card synchronisations")
            line = {"path": label, "ranks": world, "patches": outs[0]["patches"],
                    "seq": outs[0]["seq"],
                    "seconds_per_rank": [o["seconds"] for o in outs],
                    "seconds_note": note,
                    "peak_gib_per_rank": [o["peak_gib"] for o in outs],
                    "collectives_timed_run": {
                        "wall_s": [o["timed_wall_s"] for o in outs],
                        "in_collectives_s": [o["collective_s"] for o in outs]},
                    "launches_per_rank": [o["launches"] for o in outs],
                    "expected_per_rank": [o["expected"] for o in outs],
                    "rel_err_vs_emulated": rels, "bar": bar,
                    "emulated_on": str(ref_device)}
            print("spmd_prompt_check" if label == "spmd_prompt" else
                  "spmd_check", json.dumps(line), flush=True)
            for r, o in enumerate(outs):
                check(bool(np.isfinite(o["image"]).all()),
                      f"{label}: rank {r} image not finite")
                check(o["launches"] == o["expected"],
                      f"{label}: rank {r} launches {o['launches']}, the trace "
                      f"needs {o['expected']}")
                check(o["kernel_stats"] == {"launches": o["launches"]},
                      f"{label}: rank {r} kernel_stats mismatch")
                check(np.array_equal(o["image"], outs[0]["image"]),
                      f"{label}: rank {r} returned another image than rank 0")
            check(max(rels) < bar, f"{label}: spmd vs emulated {rels} (bar {bar})")
            results[label] = outs
    return results


# K6 at Hymba-1.5B's prefill: q [1, 2048, 25, 64], k/v [1, 2048, 5, 64]
# (a 1920-token prompt behind 128 meta tokens); (causal, window, prefix_len):
# causal only, causal + window, and the path's window + meta-token prefix
K6_S, K6_H, K6_K, K6_HD = 2048, 25, 5, 64
K6_MASKS = [(True, 0, 0), (True, 1024, 0), (True, 1024, 128)]


def k6_inputs(dtype, dev, gen):
    """q, k, v at the path's shapes; q and k of std QK_STD as for K1."""
    q = QK_STD * torch.randn(1, K6_S, K6_H, K6_HD, generator=gen)
    k = QK_STD * torch.randn(1, K6_S, K6_K, K6_HD, generator=gen)
    v = torch.randn(1, K6_S, K6_K, K6_HD, generator=gen)
    return [t.to(dtype).to(dev) for t in (q, k, v)]


def k6_planted_faults(ref, q, k, v, causal, window, prefix):
    """K6's output under planted faults, from its plain version: the prefix
    ignored, the window one key wider, KV head h % K for query head h."""
    wrong = [h % K6_K for h in range(K6_H)]
    return {"prefix ignored": ref.flash_attention_ref(q, k, v, causal=causal,
                                                       window=window),
            "window + 1": ref.flash_attention_ref(
                q, k, v, causal=causal, window=window + 1 if window else 0,
                prefix_len=prefix),
            "kv head h % K": ref.flash_attention_ref(
                q, k[:, :, wrong], v[:, :, wrong], causal=causal,
                window=window, prefix_len=prefix)}


def k6_bound_ms(ref, causal, window, prefix, dtype, peaks):
    """Least time for K6's work: 4 * hd operations per visible (q, k) pair
    and head (the mask's pairs, counted) at the input type's peak, or the
    bytes of q, k, v and the output once each at the memory rate."""
    pairs = int(ref.flash_mask(K6_S, K6_S, causal=causal, window=window,
                               prefix_len=prefix).sum())
    flops = 4 * K6_HD * pairs * K6_H
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = elem * K6_S * K6_HD * (2 * K6_H + 2 * K6_K)
    ops_ms = flops / (peaks[0] if dtype == torch.bfloat16 else peaks[1]) * 1e3
    bytes_ms = nbytes / peaks[2] * 1e3
    return (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes",
            pairs)


def k6_library_call(ref, q, k, v, causal, window, prefix):
    """The library yardstick: one scaled_dot_product_attention call with
    GQA (enable_gqa), is_causal for the causal-only mask, else the boolean
    window + prefix mask."""
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window == 0:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                      enable_gqa=True)
    mask = ref.flash_mask(K6_S, K6_S, causal=causal, window=window,
                          prefix_len=prefix, device=q.device)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)


def phase_k6(ops, ref, dev, peaks):
    """K6 against its plain version at Hymba's prefill shapes, each mask,
    fp32 and bf16, with planted faults (K1's bars); times at bf16. Returns
    the timed readings, the path's mask (window + prefix) first."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 7)
    timed, rejected = [], set()
    for dtype in (torch.float32, torch.bfloat16):
        for causal, window, prefix in K6_MASKS:
            q, k, v = k6_inputs(dtype, dev, gen)
            kw = dict(causal=causal, window=window, prefix_len=prefix)
            out = ops.flash_attention(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            line = {"kernel": "flash_attention", "dtype": str(dtype),
                    "q": list(q.shape), "kv": list(k.shape), **kw,
                    "bar": BARS[dtype], "norm_bar": NORM_BARS[dtype]}
            if dtype == torch.bfloat16:
                bound_ms, bound_by, pairs = k6_bound_ms(ref, causal, window,
                                                        prefix, dtype, peaks)
                line.update(
                    ms=time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
                    plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                                     reps=3),
                    library_ms=time_ms(k6_library_call(ref, q, k, v, causal,
                                                       window, prefix)),
                    visible_pairs_per_head=pairs, bound_ms=bound_ms,
                    bound_by=bound_by)
            faults = check_with_faults(
                "k6_check", out, want,
                k6_planted_faults(ref, q, k, v, causal, window, prefix),
                dtype, line)
            rejected |= {n for n, f in faults.items() if f.get("rejected")}
            if "ms" in line:
                timed.append(line)
    check(len(rejected) == 3, f"K6: not every planted fault was shown "
          f"rejected at some mask: {sorted(rejected)}")
    return sorted(timed, key=lambda line: -line["prefix_len"])


# K7 at Hymba-1.5B's Mamba branch: d_inner 1600, N 16, fp32; S 2048 at
# prefill, 1 at decode
K7_DI, K7_N, K7_TILE = 1600, 16, 64


def k7_inputs(S, dev, gen):
    """x, dt (a softplus, as Mamba's delta), B_t and C_t as the two strided
    halves of one [1, S, 2N] projection (as mamba._proj slices them), A
    negative, D, and a nonzero h0."""
    x = torch.randn(1, S, K7_DI, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(1, S, K7_DI, generator=gen) - 2)
    bc = torch.randn(1, S, 2 * K7_N, generator=gen)
    a = -torch.exp(0.5 * torch.randn(K7_DI, K7_N, generator=gen))
    d = torch.randn(K7_DI, generator=gen)
    h0 = torch.randn(1, K7_DI, K7_N, generator=gen)
    x, dt, bc, a, d, h0 = (t.to(dev) for t in (x, dt, bc, a, d, h0))
    return x, dt, bc[..., :K7_N], bc[..., K7_N:], a, d, h0


def k7_planted_faults(ref, x, dt, b, c, a, d, h0, chunk):
    """K7's (y, h_final) under planted faults, from its plain versions: h0
    ignored, the state reset at the first 64-step tile boundary, the D x
    skip dropped, and at the scan body's first chunk boundary (``chunk``
    steps) the carry dropped or entering without its decay."""
    faults = {"d x dropped": ref.ssm_scan_ref(x, dt, b, c, a,
                                              torch.zeros_like(d), h0)}
    if h0 is not None:
        faults["h0 ignored"] = ref.ssm_scan_ref(x, dt, b, c, a, d)
    if x.shape[1] > K7_TILE:
        cut = lambda lo, hi: [t[:, lo:hi] for t in (x, dt, b, c)]
        head = ref.ssm_scan_ref(*cut(0, K7_TILE), a, d, h0)
        tail = ref.ssm_scan_ref(*cut(K7_TILE, None), a, d)
        faults["state reset at a tile"] = (torch.cat([head[0], tail[0]], 1),
                                           tail[1])
    if x.shape[1] > chunk:
        for fault in ref.SCAN_FAULTS:
            faults[fault] = ref.ssm_scan_chunked_ref(x, dt, b, c, a, d, h0,
                                                     chunk=chunk, fault=fault)
    return faults


def k7_bound_ms(S, peaks):
    """Least time for K7's work: the bytes of x, dt, B_t, C_t, A, D and h0
    read once and y and h_final written once (fp32) at the memory rate, or
    its fp32 operations (per (t, d, n): the exp's argument, the decay, the
    input term and its update, the C product and its sum, 7; per (t, d):
    the D x term, 2; exp counted as one) at the CUDA-core peak."""
    nbytes = 4 * (3 * S * K7_DI + 2 * S * K7_N + K7_DI * K7_N + K7_DI
                  + 2 * K7_DI * K7_N)
    flops = S * K7_DI * (7 * K7_N + 2)
    ops_ms = flops / peaks[1] * 1e3
    bytes_ms = nbytes / peaks[2] * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def phase_k7(ops, ref, dev, peaks):
    """K7 against its plain version at Hymba's prefill (S 2048) and decode
    (S 1) shapes, from zero and from a nonzero state, fp32 5e-5 on y and the
    final state, with planted faults; times with h0 and the final state, as
    mamba_forward calls it. Returns the timed readings, prefill first."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 8)
    timed, rejected = [], set()
    f32 = torch.float32
    for S in (2048, 1):
        for with_h0 in (False, True):
            x, dt, b, c, a, d, h0 = k7_inputs(S, dev, gen)
            h0 = h0 if with_h0 else None
            y, h = ops.ssm_scan(x, dt, b, c, a, d, h0=h0, final_state=True)
            want = ref.ssm_scan_ref(x, dt, b, c, a, d, h0)
            yerr, yrel, yok = k1_reading(y, want[0], f32)
            herr, hrel, hok = k1_reading(h, want[1], f32)
            readings = {}
            faults = k7_planted_faults(ref, x, dt, b, c, a, d, h0,
                                       ops.ss.SCAN_CHUNK)
            for name, bad in faults.items():
                _, ry, y_ok = k1_reading(y, bad[0], f32)
                _, rh, h_ok = k1_reading(h, bad[1], f32)
                readings[name] = {"y_norm_rel_err": ry, "h_norm_rel_err": rh,
                                  "rejected": not (y_ok and h_ok)}
                if not (y_ok and h_ok):
                    rejected.add(name)
            line = {"kernel": "ssm_scan", "S": S, "Di": K7_DI, "N": K7_N,
                    "h0": with_h0, "max_abs_err": max(yerr, herr),
                    "y_max_abs_err": yerr, "y_norm_rel_err": yrel,
                    "h_max_abs_err": herr, "h_norm_rel_err": hrel,
                    "bar": BARS[f32], "ok": yok and hok,
                    "planted_faults": readings}
            if with_h0:
                bound_ms, bound_by = k7_bound_ms(S, peaks)
                kernel = lambda: ops.ssm_scan(x, dt, b, c, a, d, h0=h0,
                                              final_state=True)
                plain = lambda: ref.ssm_scan_ref(x, dt, b, c, a, d, h0)
                if S == 1:     # microseconds: device time by CUDA-graph replay
                    line.update(ms=time_graph_ms(kernel),
                                plain_ms=time_graph_ms(plain),
                                eager_ms=time_ms(kernel, reps=100))
                else:
                    line.update(ms=time_ms(kernel), plain_ms=time_ms(plain, reps=3))
                line.update(
                    library_ms=None,
                    library_call="none: no single PyTorch call computes a "
                                 "selective scan",
                    bound_ms=bound_ms, bound_by=bound_by)
                timed.append(line)
            print("k7_check", json.dumps(line), flush=True)
            check(line["ok"], f"K7 disagrees with its plain version: {line}")
            check(all(f["rejected"] for f in readings.values()),
                  f"the K7 bar lets a planted fault through: {line}")
    check(len(rejected) == 3 + len(ref.SCAN_FAULTS), f"K7: not every planted "
          f"fault was shown rejected: {sorted(rejected)}")
    return timed


# Hymba-1.5B serving at full width (32 layers, d_model 1600, 25/5 heads of
# 64, vocab 32001), bf16, random weights from SEED: 4 requests on 4 slots,
# prompts of 1920 tokens (128 meta + 1920 = 2048 positions, past the
# 128 + 1024 ring), 16 new tokens each
HYMBA_REQUESTS, HYMBA_PROMPT, HYMBA_NEW = 4, 1920, 16


def hymba_engine(dev):
    """The full-width bf16 engine and its requests' prompts, through the
    entry points a user calls (get_config, build_model, Model.init,
    ServingEngine)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine

    cfg = get_config("hymba-1.5b").replace(dtype="bfloat16",
                                           param_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    engine_args = dict(slots=HYMBA_REQUESTS, max_len=HYMBA_PROMPT + HYMBA_NEW + 8,
                       window=cfg.sliding_window)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, HYMBA_PROMPT).astype(np.int32)
               for _ in range(HYMBA_REQUESTS)]
    return cfg, lambda: ServingEngine(model, params, **engine_args), prompts


def hymba_serve_once(make_engine, prompts):
    """Submit every request, run to completion; (requests by uid, start and
    end on the host clock, after a card synchronisation)."""
    from repro_torch.serving import Request

    engine = make_engine()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for uid, prompt in enumerate(prompts):
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=HYMBA_NEW))
    done = engine.run_to_completion()
    torch.cuda.synchronize()
    return {r.uid: r for r in done}, t0, time.perf_counter()


def phase_hymba(ops, dev):
    """The LLM serving path at full width: a warm-up run, a run with the
    launch counters set to 0 just before it and read just after (K6 once
    per layer of each prefill, K7 once per layer of each prefill and decode
    step), the two runs' tokens equal, then the first request alone,
    timed and profiled. Returns the counted run's launches."""
    cfg, make_engine, prompts = hymba_engine(dev)
    print(f"hymba-1.5b: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.hd}, vocab {cfg.vocab}, "
          f"{cfg.dtype}, window {cfg.sliding_window}, meta "
          f"{cfg.n_meta_tokens}; {HYMBA_REQUESTS} requests of "
          f"{HYMBA_PROMPT} tokens on {HYMBA_REQUESTS} slots, {HYMBA_NEW} new "
          "tokens each", flush=True)
    t0 = time.perf_counter()
    first, _, _ = hymba_serve_once(make_engine, prompts)
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    done, t0, t1 = hymba_serve_once(make_engine, prompts)
    launches = ops.launch_counts()
    expected = {"flash_attention": HYMBA_REQUESTS * cfg.n_layers,
                "ssm_scan": HYMBA_REQUESTS * cfg.n_layers * HYMBA_NEW}
    tokens = {uid: r.out_tokens for uid, r in done.items()}
    n_tok = sum(map(len, tokens.values()))
    ttft = [done[uid].first_token_s - t0 for uid in sorted(done)]
    decode_s = t1 - max(r.first_token_s for r in done.values())
    line = {"path": "hymba_serve", "requests": HYMBA_REQUESTS,
            "prompt_tokens": HYMBA_PROMPT, "new_tokens": HYMBA_NEW,
            "wall_s": t1 - t0, "first_run_s": first_s,
            "ttft_ms": [x * 1e3 for x in ttft],
            "ttft_ms_note": "from submitting all requests; the engine "
                            "prefills them one after another",
            "decode_ms_per_token": decode_s / (n_tok - HYMBA_REQUESTS) * 1e3,
            "tokens_per_s": n_tok / (t1 - t0),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches, "expected_launches": expected,
            "tokens": tokens}
    print("hymba_serve", json.dumps(line), flush=True)
    check(sorted(done) == list(range(HYMBA_REQUESTS)), "hymba: requests lost")
    check(all(len(t) == HYMBA_NEW and all(0 <= x < cfg.vocab for x in t)
              for t in tokens.values()), f"hymba: tokens {tokens}")
    check(tokens == {uid: r.out_tokens for uid, r in first.items()},
          "hymba: two runs gave different tokens")
    check(launches == expected, f"hymba: launches {launches}, the config "
          f"needs {expected}")
    profile_hymba(make_engine, prompts[:1])
    return launches


def profile_hymba(make_engine, prompts, top=12):
    """``prompts`` served once unprofiled and once under torch.profiler:
    device time by kernel and the device idle share (1 - busy / the
    unprofiled wall time). The engine runs each request's prefill and
    decode steps at batch 1 whatever its slots, so one request is the
    path's work per request; the whole 4-request run launches a few
    hundred thousand kernels, more than the profiler reads back in the
    script's time. Only the device is traced, for the same reason."""
    from torch.profiler import ProfilerActivity, profile

    _, t0, t1 = hymba_serve_once(make_engine, prompts)
    wall_s = t1 - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        hymba_serve_once(make_engine, prompts)
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((ev.key, dev_us, ev.count))
    kernels.sort(key=lambda k: -k[1])
    busy_s = sum(us for _, us, _ in kernels) * 1e-6
    by = {name: sum(us for key, us, _ in kernels if name in key) * 1e-6
          for name in ("flash_attention", "ssm_scan")}
    print("hymba_serve_profile", json.dumps({
        "requests": len(prompts), "wall_s": wall_s, "device_busy_s": busy_s,
        "device_kernels": sum(c for _, _, c in kernels),
        "device_idle_share": max(0.0, 1.0 - busy_s / wall_s),
        "k6_device_s": by["flash_attention"], "k7_device_s": by["ssm_scan"],
        "k6_share_of_busy": by["flash_attention"] / busy_s if busy_s else None,
        "k7_share_of_busy": by["ssm_scan"] / busy_s if busy_s else None,
        "top_kernels": [{"name": n[:120], "device_s": us * 1e-6, "calls": c}
                        for n, us, c in kernels[:top]]}), flush=True)


def phase_hymba_cross_device(dev):
    """hymba-1.5b reduced in fp32 with GQA (4 query, 2 KV heads): a 96-token
    prompt (past the 8 + 64 ring) prefilled and 8 tokens decoded on the card
    (K6, K7) and on the CPU (their plain versions), each fed the CPU's
    tokens: logits within 1e-4 relative, the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("hymba-1.5b").reduced().replace(n_kv_heads=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(SEED))
    tokens = torch.randint(0, cfg.vocab, (1, 96),
                           generator=torch.Generator().manual_seed(SEED + 1))

    def to(tree, d):
        return {k: to(v, d) if isinstance(v, dict) else v.to(d)
                for k, v in tree.items()}

    def run(d, feed):
        p = to(params, d)
        cache = model.init_cache(1, 0, window=cfg.sliding_window, device=d)
        out, cache = model.prefill(p, {"tokens": tokens.to(d)}, cache,
                                   window=cfg.sliding_window)
        seq = [out.cpu()]
        for i in range(8):
            tok = seq[-1].argmax(-1) if feed is None else feed[i:i + 1]
            out, cache = model.decode_step(p, cache, tok.to(d),
                                           window=cfg.sliding_window)
            seq.append(out.cpu())
        return torch.cat(seq)

    want = run("cpu", None)
    got = run(dev, want.argmax(-1))
    rel = ((got - want).norm() / want.norm()).item()
    same = torch.equal(got.argmax(-1), want.argmax(-1))
    print(f"cross_device hymba-1.5b.reduced fp32 GQA 4/2: card vs CPU logits "
          f"relative error {rel:.3e} (bar 1e-4), same tokens {same}", flush=True)
    check(rel < 1e-4 and same, f"hymba: card differs from the CPU: {rel}, {same}")
    return rel


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
    if sys.argv[1:] == ["--nccl"]:
        # the multi-rank paths alone, over NCCL with one card per rank
        check(torch.cuda.device_count() >= 4, "--nccl needs 4 cards")
        spmd = phase_spmd(dev, dist_backend="nccl")
        _, chain_s = phase_chain_ranks(dev, dist_backend="nccl")
        video = phase_spmd_frames(dev, dist_backend="nccl")
        print(json.dumps({"nccl_makespan_s": {
            **{label: max(o["seconds"] for o in outs)
               for label, outs in spmd.items()},
            **{label: max(per_rank) for label, per_rank in chain_s.items()},
            "spmd_frames": max(o["timed_wall_s"] for o in video)}}),
            flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
        return 0
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}; the one "
          "option is --nccl (the multi-rank paths on 4 cards)")
    def phase(fn, *args):
        """Run one phase and print its seconds (the script's time limit
        covers them all)."""
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {fn.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    k1 = phase(phase_kernels, ops, ref, layers, dev, peaks)
    k1_b2 = phase(phase_k1_batch2, ops, ref, layers, dev, peaks)
    k3 = phase(phase_k3, ops, ref, dev, peaks)
    k2_timed = phase(phase_k2, ops, ref, dev, peaks)
    k2 = k2_timed[0]
    k5 = phase(phase_k5, ops, ref, dev, peaks)
    k1_lanes = phase(phase_k1_lanes, ops, ref, layers, dev, peaks)
    k2_cohort = phase(phase_k2_cohorts, ops, ref, dev, peaks)
    k1_ctx, k2_ctx = phase(phase_ctx2n, ops, ref, layers, dev, peaks)
    k4_timed = phase(phase_k4, ops, ref, dev, peaks)
    k4 = k4_timed[0]
    k6_timed = phase(phase_k6, ops, ref, dev, peaks)
    k7_timed = phase(phase_k7, ops, ref, dev, peaks)
    hymba_launches = phase(phase_hymba, ops, dev)
    phase(phase_hymba_cross_device, dev)
    launches = phase(phase_paths, ops, dev)
    launches["hymba_serve"] = hymba_launches
    launches["diffusion_serve"] = phase(phase_diffusion_serve, ops, dev)
    launches.update(phase(phase_pipefuse, ops, dev))
    launches["diffusion_serve_pipefuse"] = phase(
        phase_diffusion_serve_pipefuse, ops, dev)
    launches.update(phase(phase_frames, ops, dev))
    launches.update(phase(phase_prompt, ops, dev, launches))
    spmd = phase(phase_spmd, dev)
    spmd["spmd_frames"] = phase(phase_spmd_frames, dev)
    launches.update(phase(phase_chain_ranks, dev)[0])
    phase(phase_cross_device, dev)
    for label, outs in spmd.items():      # launches summed over the ranks
        launches[label] = {}
        for o in outs:
            for kernel, n in o["launches"].items():
                launches[label][kernel] = launches[label].get(kernel, 0) + n

    def entry(name, source, replaces, reading, main_label):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": launches[main_label].get(name, 0),
                "max_abs_err": reading["max_abs_err"], "ms": reading["ms"],
                "plain_ms": reading["plain_ms"], "bound_ms": reading["bound_ms"],
                "bound_by": reading["bound_by"],
                "library_ms": reading["library_ms"],
                "launches_by_path": {label: n.get(name, 0)
                                     for label, n in launches.items()}}
    skv_cu = "src/repro_torch/kernels/csrc/stale_kv_attention.cu"
    record = {"kernels": [
        {**entry("stale_kv_attention", skv_cu,
                 "src/repro/kernels/stale_kv_attention.py:69", k1, "main_path"),
         "batch2_ms": k1_b2["ms"], "batch2_bound_ms": k1_b2["bound_ms"],
         "lanes4": {k: k1_lanes[k] for k in (
             "Nl", "ms", "plain_ms", "library_ms", "bound_ms")},
         "ctx2n": [{k: line[k] for k in (
             "batch", "N", "Nl", "tok_start", "ms", "plain_ms", "library_ms",
             "bound_ms", "max_abs_err")} for line in k1_ctx],
         "wrapper_host_us": k1["wrapper_host_us"]},
        {**entry("cfg_epilogue", "src/repro_torch/kernels/csrc/cfg_epilogue.cu",
                 "src/repro/kernels/cfg_epilogue.py:34", k3, "diffusion_serve"),
         "eager_ms": k3["eager_ms"], "floor_ms": k3["floor_ms"],
         "timed_lane_groups": [{k: line[k] for k in (
             "shape", "G", "with_delta", "per_lane", "ms", "floor_ms",
             "plain_ms", "library_ms", "bound_ms", "eager_ms")}
            for line in k3["lane_groups"]]},
        {**entry("stale_kv_attention_padded", skv_cu,
                 "src/repro/kernels/stale_kv_attention.py:161", k2, "spmd"),
         "launches_per_rank": [o["launches"].get("stale_kv_attention_padded", 0)
                               for o in spmd["spmd"]],
         "cohort4": {k: k2_cohort[k] for k in (
             "tok_start", "valid_tokens", "ms", "plain_ms", "library_ms",
             "bound_ms")},
         "ctx2n": [{k: line[k] for k in (
             "n_tokens", "Nl_max", "tok_start", "valid_tokens", "ms",
             "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
            for line in k2_ctx],
         "launches_per_rank_spmd_frames": [
             o["launches"].get("stale_kv_attention_padded", 0)
             for o in spmd["spmd_frames"]],
         "timed_layouts": [{k: line[k] for k in (
             "batch", "tok_start", "valid_tokens", "ms", "plain_ms",
             "library_ms", "bound_ms", "wrapper_host_us")} for line in k2_timed]},
        {**entry("stale_kv_attention_guided", skv_cu,
                 "src/repro/kernels/stale_kv_attention.py:268", k5, "spmd_fused"),
         "on_a_path": False, "wrapper_host_us": k5["wrapper_host_us"]},
        {**entry("lse_attention", skv_cu,
                 "src/repro/kernels/stale_kv_attention.py:371", k4, "spmd_seq"),
         "launches_per_rank": [o["launches"].get("lse_attention", 0)
                               for o in spmd["spmd_seq"]],
         "library_call": k4["library_call"],
         "timed_hops": [{k: line[k] for k in (
             "valid_len", "ms", "plain_ms", "library_ms", "bound_ms",
             "wrapper_host_us")} for line in k4_timed]},
        {**entry("flash_attention",
                 "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:68", k6_timed[0],
                 "hymba_serve"),
         "timed_masks": [{k: line[k] for k in (
             "causal", "window", "prefix_len", "ms", "plain_ms", "library_ms",
             "bound_ms", "visible_pairs_per_head")} for line in k6_timed]},
        {**entry("ssm_scan", "src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:55", k7_timed[0], "hymba_serve"),
         "library_call": k7_timed[0]["library_call"],
         "timed_lengths": [{k: line[k] for k in (
             "S", "ms", "plain_ms", "bound_ms")} for line in k7_timed],
         "decode_eager_ms": k7_timed[1]["eager_ms"]},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
