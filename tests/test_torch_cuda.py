"""Card-only tests of the port's CUDA kernels (marker ``cuda``): each kernel
against its plain PyTorch version at the shapes ``chip_smoke.py`` checks,
the guided path on the card against the CPU, ``run_spmd`` on two gloo
ranks and ``run_spmd_seq`` on four that share the card against the CPU,
Hymba's prefill and decode (K6, K7) on the card against the CPU, K6 at
the dense decoders' head dims (128, 256) and gemma-2b reduced on the card
against the CPU, K6's non-causal form at the enc-dec LM's shapes, the K1
autograd Function's gradients against the plain version's and its refusal
of a grad operand outside it, the K6 and K7 Functions' gradients against
the plain versions', and a tensor-parallel step on two gloo ranks sharing
the card. They skip
on a machine without a CUDA device. No JAX here: the machine with the card
has none. Run them there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

# (N, Nl, tok_start): sdxl-dit's two main-path patches, its warm-up
# (all-fresh) layout, and a layout aligned to no tile
MAIN_PATH_CASES = [(4096, 2304, 0), (4096, 1792, 2304), (4096, 4096, 0),
                   (4096, 200, 72)]
# std of q and k: the scores q.k / sqrt(hd) have std 1.5**2, a peaked
# softmax as in a trained model, so outputs are of order one
QK_STD = 1.5
# fp32: DESIGN.md §15's kernel bar. bf16: the kernel and the plain version
# each round the output to bf16 once, and may land one unit in the last place
# apart (under 2^-7 relative); the norm-relative bar is a few times what
# that gives and well under what a skipped key tile or a patch off by one
# tile gives (test_bar_rejects_planted_faults).
BARS = {torch.float32: dict(atol=5e-5, rtol=0.0),
        torch.bfloat16: dict(atol=1e-3, rtol=1e-2)}
NORM_BARS = {torch.float32: 5e-5, torch.bfloat16: 2e-3}
TILE = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(N, Nl, dtype, device, B=1, H=16, hd=72, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def mk(n, std):
        return (std * torch.randn(B, n, H, hd, generator=g)).to(dtype).to(device)
    return mk(Nl, QK_STD), mk(Nl, QK_STD), mk(Nl, 1.0), mk(N, QK_STD), mk(N, 1.0)


def _within_bars(out, want, dtype):
    out, want = out.float(), want.float()
    rel = ((out - want).norm() / want.norm()).item()
    return torch.allclose(out, want, **BARS[dtype]) and rel <= NORM_BARS[dtype]


def _assert_within_bars(out, want, dtype):
    torch.testing.assert_close(out.float(), want.float(), **BARS[dtype])
    rel = ((out.float() - want.float()).norm() / want.float().norm()).item()
    assert rel <= NORM_BARS[dtype], rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Nl,tok_start", MAIN_PATH_CASES)
def test_stale_kv_kernel_matches_plain(cuda, N, Nl, tok_start, dtype):
    q, kf, vf, ks, vs = _inputs(N, Nl, dtype, cuda)
    out = ops.stale_kv_attention(q, kf, vf, ks, vs, tok_start=tok_start)
    want = ref.stale_kv_attention_ref(q, kf, vf, ks, vs, tok_start)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    _assert_within_bars(out, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Nl,tok_start", [(4096, 2304, 0), (4096, 200, 72)])
def test_bar_rejects_planted_faults(cuda, N, Nl, tok_start, dtype):
    """The kernel's output is outside the bar around a plain version with a
    planted fault: a 64-key tile skipped (fresh, and the context's last),
    or the patch placed one tile off."""
    q, kf, vf, ks, vs = _inputs(N, Nl, dtype, cuda)
    out = ops.stale_kv_attention(q, kf, vf, ks, vs, tok_start=tok_start)
    full_k, full_v = ks.clone(), vs.clone()
    full_k[:, tok_start:tok_start + Nl] = kf
    full_v[:, tok_start:tok_start + Nl] = vf
    for t0 in (tok_start, N - TILE):
        keep = torch.ones(1, 1, 1, N, dtype=torch.bool, device=cuda)
        keep[..., t0:t0 + TILE] = False
        bad = layers.attend(q.float(), full_k.float(), full_v.float(), mask=keep)
        assert not _within_bars(out, bad.to(dtype), dtype), t0
    bad = ref.stale_kv_attention_ref(q, kf, vf, ks, vs, tok_start + TILE)
    assert not _within_bars(out, bad, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 72])
def test_stale_kv_kernel_reads_strided_views(cuda, dtype, hd):
    """The block stack hands the kernel q/k/v as views of the fused qkv
    projection and the stale K/V as one layer of the [L,B,N,H,hd] buffer."""
    B, N, Nl, H, L = 2, 256, 96, 4, 3
    g = torch.Generator(device="cpu").manual_seed(1)
    qkv = torch.randn(B, Nl, 3, H, hd, generator=g).to(dtype).to(cuda)
    buf_k = torch.randn(L, B, N, H, hd, generator=g).to(dtype).to(cuda)
    buf_v = torch.randn(L, B, N, H, hd, generator=g).to(dtype).to(cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = ops.stale_kv_attention(q, k, v, buf_k[1], buf_v[1], tok_start=40)
    want = ref.stale_kv_attention_ref(q, k, v, buf_k[1], buf_v[1], 40)
    _assert_within_bars(out, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stale_kv_kernel_runs_on_the_operands_card(cuda, dtype):
    """Operands on the second card while the first is current: the launch
    goes to the operands' card and its stream."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    q, kf, vf, ks, vs = _inputs(512, 128, dtype, dev, H=4)
    with torch.cuda.device(0):
        out = ops.stale_kv_attention(q, kf, vf, ks, vs, tok_start=64)
    want = ref.stale_kv_attention_ref(q, kf, vf, ks, vs, 64)
    torch.cuda.synchronize(dev)
    assert out.device == dev
    _assert_within_bars(out, want, dtype)


@pytest.mark.cuda
def test_bf16_kernel_refuses_misaligned_rows(cuda):
    x = torch.zeros(1, 64 * 72 + 1, dtype=torch.bfloat16, device=cuda)[:, 1:]
    q = x.view(1, 64, 1, 72)                     # rows start 2 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        ops.stale_kv_attention(q, q, q, q, q, tok_start=0)


@pytest.mark.cuda
def test_stale_kv_kernel_counts_launches(cuda):
    q, kf, vf, ks, vs = _inputs(256, 64, torch.float32, cuda, H=2, hd=32)
    ops.reset_launch_counts()
    ops.stale_kv_attention(q, kf, vf, ks, vs, tok_start=64)
    ops.stale_kv_attention(q, kf, vf, ks, vs, tok_start=0)
    assert ops.launch_counts() == {"stale_kv_attention": 2}


# ----------------------------------------------------------------------
# kernel K3: the CFG epilogue
# ----------------------------------------------------------------------

# sdxl-dit's eps per branch on the main path (the two patches and the full
# image), an odd length for the scalar tail
K3_SHAPES = [(1, 72, 128, 4), (1, 56, 128, 4), (1, 128, 128, 4), (36865,)]


def _k3_inputs(shape, dtype, device, offset=0, seed=0):
    """eps_c, eps_u of ``shape``; ``offset`` elements into a larger buffer,
    so offset 1 gives contiguous tensors that are not 16-byte aligned."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = math.prod(shape)
    out = []
    for _ in range(2):
        flat = torch.randn(n + offset, generator=g).to(dtype).to(device)
        out.append(flat[offset:].view(shape))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K3_SHAPES)
def test_cfg_epilogue_kernel_bitwise(cuda, shape, dtype, offset):
    """Delta and combine bitwise equal to the plain version's eager
    ``eu + w * d`` on the card (the kernel rounds each product and sum to
    nearest, with no FMA, and the bf16 output once)."""
    ec, eu = _k3_inputs(shape, dtype, cuda, offset)
    for scale in (4.0, 7.5, torch.tensor(1.5)):
        comb, delta = ops.cfg_epilogue(ec, eu, scale)
        want_comb, want_delta = ref.cfg_epilogue_ref(ec, eu, scale)
        torch.cuda.synchronize()
        assert comb.dtype == dtype and delta.dtype == torch.float32
        assert torch.equal(delta, want_delta)
        assert torch.equal(comb, want_comb)


@pytest.mark.cuda
def test_cfg_epilogue_counts_launches_and_skips_delta(cuda):
    ec, eu = _k3_inputs((1, 72, 128, 4), torch.bfloat16, cuda)
    ops.reset_launch_counts()
    comb, _ = ops.cfg_epilogue(ec, eu, 4.0)
    only = ops.cfg_epilogue(ec, eu, 4.0, with_delta=False)
    assert ops.launch_counts() == {"cfg_epilogue": 2}
    assert torch.equal(only, comb)


@pytest.mark.cuda
def test_cfg_epilogue_wrapper_refuses(cuda):
    ec, eu = _k3_inputs((4, 8, 8, 4), torch.float32, cuda)
    with pytest.raises(ValueError, match="shape and dtype"):
        ops.cfg_epilogue(ec, eu.to(torch.bfloat16), 4.0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.cfg_epilogue(ec.transpose(1, 2), eu.transpose(1, 2), 4.0)
    with pytest.raises(ValueError, match="one entry a lane"):
        ops.cfg_epilogue(ec, eu, torch.full((4, 1, 1, 1), 4.0, device=cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.cfg_epilogue(ec.half(), eu.half(), 4.0)


# per-lane scales: lanes of the guided patch and warm-up eps, and a lane of
# 105 elements (not a multiple of the 8 bf16 or 4 fp32 of a 16-byte vector)
K3_LANES = [(72, 128, 4), (128, 128, 4), (5, 7, 3)]
K3_SCALES = (3.0, 5.0, 7.5, 1.0, 2.5, 4.0, 0.5, 6.0)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lane", K3_LANES)
@pytest.mark.parametrize("G", [1, 3, 4, 8])
def test_cfg_epilogue_per_lane_bitwise(cuda, G, lane, dtype, offset):
    """One launch over a lane group [G, ...] with a device vector of one
    scale a lane: delta and combine bitwise the plain version's; the check
    rejects lane 0's scale used for every lane (the planted fault)."""
    ec, eu = _k3_inputs((G,) + lane, dtype, cuda, offset, seed=G)
    scales = torch.tensor(K3_SCALES[:G], device=cuda)
    ops.reset_launch_counts()
    comb, delta = ops.cfg_epilogue(ec, eu, scales)
    only = ops.cfg_epilogue(ec, eu, scales, with_delta=False)
    assert ops.launch_counts() == {"cfg_epilogue": 2}
    want_comb, want_delta = ref.cfg_epilogue_ref(ec, eu, scales)
    assert torch.equal(delta, want_delta)
    assert torch.equal(comb, want_comb) and torch.equal(only, comb)
    fault = ops.cfg_epilogue(ec, eu, scales[0], with_delta=False)
    assert torch.equal(fault, ref.cfg_epilogue_ref(ec, eu, scales[:1].expand(G))[0])
    assert G == 1 or not torch.equal(fault, want_comb)


@pytest.mark.cuda
def test_cfg_epilogue_refuses_wrong_scale_vectors(cuda):
    ec, eu = _k3_inputs((4, 8, 8, 4), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="one entry a lane"):
        ops.cfg_epilogue(ec, eu, torch.ones(3, device=cuda))
    with pytest.raises(ValueError, match="in place"):
        ops.cfg_epilogue(ec, eu, torch.ones(4))          # on the host
    with pytest.raises(ValueError, match="in place"):
        ops.cfg_epilogue(ec, eu, torch.ones(4, device=cuda, dtype=torch.float64))
    ops.reset_launch_counts()
    ops.cfg_epilogue(ec, eu, torch.tensor(2.0))          # a host number
    ops.cfg_epilogue(ec, eu, torch.tensor(2.0, device=cuda))
    assert ops.launch_counts() == {"cfg_epilogue": 2}


@pytest.mark.cuda
def test_serving_round_launches_k3_once_per_guided_dispatch(cuda):
    """tiny-dit.reduced() in fp32 served on the card (two guided scales and
    an unguided lane, staggered): K3 once per guided dispatch, whatever its
    lane count, K1 once a layer of every dispatch, and the images within
    1e-3 of the CPU engine's."""
    from repro_torch.configs import get_config
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiConfig, StadiPipeline
    from repro_torch.models.diffusion import dit
    from repro_torch.serving import DiffusionServingEngine

    cfg = get_config("tiny-dit").reduced()
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = dit.nondegenerate_params(dit.init_params(gen, cfg), gen)
    xs = torch.randn(4, 1, cfg.latent_size, cfg.latent_size, cfg.channels,
                     generator=gen)
    config = StadiConfig.from_occupancies([0.0, 0.5], m_base=8, m_warmup=2)
    images = {}
    for dev in ("cpu", cuda):
        engine = DiffusionServingEngine(
            StadiPipeline(cfg, params, sampler.linear_schedule(1000), config,
                          device=dev), slots=3)
        reqs = []
        for i, scale in enumerate((3.0, 5.0, None, 3.0)):
            if i == 3:
                engine.step()
            reqs.append(engine.submit(xs[i], i, cfg_scale=scale))
        engine.run_to_completion()
        images[str(dev)] = [r.image.cpu() for r in reqs]
        stats = engine.stats()
    d = stats["dispatches"]
    assert d["guided"] > 0 and d["plain"] > 0
    assert stats["kernels"] == {"cfg_epilogue": d["guided"],
                                "stale_kv_attention": cfg.n_layers
                                * (d["guided"] + d["plain"])}
    for got, want in zip(images["cuda"], images["cpu"]):
        assert ((got - want).norm() / want.norm()).item() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stale_kv_kernel_batch2_from_branch_stacked_buffer(cuda, dtype):
    """Both guidance branches of one layer in one launch: the stale K/V are
    a strided [2, N, H, hd] view of the branch-stacked [2, L, 1, N, H, hd]
    buffer, as dit.forward_patch_cfg hands them over at batch 1."""
    N, Nl, tok, H, hd, L = 4096, 2304, 0, 16, 72, 3
    g = torch.Generator(device="cpu").manual_seed(2)
    mk = lambda *shape, std=1.0: (std * torch.randn(*shape, generator=g)).to(
        dtype).to(cuda)
    buf_k, buf_v = mk(2, L, 1, N, H, hd, std=QK_STD), mk(2, L, 1, N, H, hd)
    qkv = mk(2, Nl, 3, H, hd, std=QK_STD)
    ks = buf_k.transpose(0, 1).flatten(1, 2)[1]
    vs = buf_v.transpose(0, 1).flatten(1, 2)[1]
    assert ks.shape == (2, N, H, hd) and ks.data_ptr() == buf_k[0, 1].data_ptr()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = ops.stale_kv_attention(q, k, v, ks, vs, tok_start=tok)
    want = ref.stale_kv_attention_ref(q, k, v, ks, vs, tok)
    torch.cuda.synchronize()
    _assert_within_bars(out, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fused", "interleaved"])
def test_guided_generate_on_card_matches_cpu(cuda, mode):
    """tiny-dit.reduced() in fp32, guided: the card's image (K1 at batch 2,
    K3) against the CPU's (plain versions), and K3 launched once per guided
    eval whose uncond branch is fresh."""
    from repro_torch.configs import get_config
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiConfig, StadiPipeline
    from repro_torch.models.diffusion import dit

    cfg = get_config("tiny-dit").reduced()
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = dit.nondegenerate_params(dit.init_params(gen, cfg), gen)
    x_T = torch.randn(1, cfg.latent_size, cfg.latent_size, cfg.channels,
                      generator=gen)
    cond = torch.tensor([3])
    knobs = dict(m_base=16, m_warmup=4, cfg_scale=4.0)
    if mode == "interleaved":
        knobs.update(planner="stadi_guidance", guidance="interleaved")
    config = StadiConfig.from_occupancies([0.0, 0.0, 0.5, 0.5], **knobs)
    res = {d: StadiPipeline(cfg, params, sampler.linear_schedule(1000), config,
                            device=d).generate(x_T, cond) for d in ("cpu", cuda)}
    img, want = res[cuda].image.cpu(), res["cpu"].image
    assert ((img - want).norm() / want.norm()).item() < 1e-3
    trace = res[cuda].trace
    evals = fresh = 0
    for e in trace.events:                 # one eval per warm-up step
        subs = [1] if e.synchronous else e.substeps
        evals += sum(subs)
        fresh += sum(s for i, s in enumerate(subs) if e.synchronous
                     or e.uncond_fresh or not trace.guidance.worker_reuses(i))
    assert res[cuda].kernel_stats["launches"]["cfg_epilogue"] == fresh
    assert (fresh < evals) == (mode == "interleaved")


# ----------------------------------------------------------------------
# kernels K2 and K5: the multi-rank (padded) forms
# ----------------------------------------------------------------------

# sdxl-dit's spmd main path: slab Nl_max 2304 (patches [36, 28] token rows),
# buffer n_tokens 4096 + 2304 scratch rows; (tok_start, valid_tokens) of
# rank 0, rank 1, and rank 0 of the reversed split [28, 36], the layout at
# which ignoring valid_tokens changes the output
K2_N, K2_NL, K2_NPAD = 4096, 2304, 6400
K2_LAYOUTS = [(0, 2304), (2304, 1792), (0, 1792)]


def _k2_inputs(dtype, device, B=1, lead=(), seed=3):
    """Random everywhere, the slab rows past valid_tokens and the buffer's
    scratch tail included, so a dropped mask or blend shows."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def mk(n, std):
        return (std * torch.randn(*lead, B, n, 16, 72, generator=g)).to(
            dtype).to(device)
    return (mk(K2_NL, QK_STD), mk(K2_NL, QK_STD), mk(K2_NL, 1.0),
            mk(K2_NPAD, QK_STD), mk(K2_NPAD, 1.0))


def _k2_faults(plain, args, tok, valid):
    """Planted faults from the plain version: valid_tokens ignored, the
    scratch key mask dropped, tok_start one 64-key tile off."""
    return [plain(*args, tok, K2_NL, K2_N), plain(*args, tok, valid, K2_NPAD),
            plain(*args, tok + TILE, valid, K2_N)]


def _assert_rejects_faults(out, want, faults, dtype):
    """Every fault that changes the function at this layout is outside
    the bars."""
    for bad in faults:
        moved = ((bad.float() - want.float()).norm() / want.float().norm()).item()
        if moved >= 1e-6:
            assert not _within_bars(out, bad, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("tok,valid", K2_LAYOUTS)
def test_k2_kernel_matches_plain_and_rejects_faults(cuda, tok, valid, B, dtype):
    args = _k2_inputs(dtype, cuda, B)
    ops.reset_launch_counts()
    out = ops.stale_kv_attention_padded(*args, tok, valid, n_tokens=K2_N)
    assert ops.launch_counts() == {"stale_kv_attention_padded": 1}
    want = ref.stale_kv_attention_padded_ref(*args, tok, valid, K2_N)
    torch.cuda.synchronize()
    assert out.shape == args[0].shape and out.dtype == dtype
    _assert_within_bars(out, want, dtype)
    _assert_rejects_faults(out, want, _k2_faults(
        ref.stale_kv_attention_padded_ref, args, tok, valid), dtype)


@pytest.mark.cuda
def test_k2_faults_show_somewhere(cuda):
    """The valid_tokens fault changes nothing at the main path's two
    layouts (the slab's scratch rows land on masked keys there) and shows
    at the third; the other two faults show at every layout."""
    args = _k2_inputs(torch.float32, cuda)
    moved = []
    for tok, valid in K2_LAYOUTS:
        want = ref.stale_kv_attention_padded_ref(*args, tok, valid, K2_N)
        moved.append([((bad - want).norm() / want.norm()).item() > 1e-6
                      for bad in _k2_faults(ref.stale_kv_attention_padded_ref,
                                            args, tok, valid)])
    assert moved == [[False, True, True], [False, True, True], [True, True, True]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("uncond_fresh", [0, 1])
def test_k5_kernel_matches_plain_and_rejects_faults(cuda, uncond_fresh, dtype):
    tok, valid = K2_LAYOUTS[2]
    args = _k2_inputs(dtype, cuda, lead=(2,), seed=4)

    def plain(*a):
        return ref.stale_kv_attention_guided_ref(*a[:-1], uncond_fresh, a[-1])
    ops.reset_launch_counts()
    out = ops.stale_kv_attention_guided(*args, tok, valid, uncond_fresh,
                                        n_tokens=K2_N)
    assert ops.launch_counts() == {"stale_kv_attention_guided": 1}
    want = plain(*args, tok, valid, K2_N)
    torch.cuda.synchronize()
    assert out.shape == args[0].shape
    _assert_within_bars(out, want, dtype)
    _assert_rejects_faults(out, want, _k2_faults(plain, args, tok, valid), dtype)


def _tiny_generate(config, device):
    """tiny-dit.reduced() in fp32 with weights and noise from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiPipeline
    from repro_torch.models.diffusion import dit

    cfg = get_config("tiny-dit").reduced()
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = dit.nondegenerate_params(dit.init_params(gen, cfg), gen)
    x_T = torch.randn(1, cfg.latent_size, cfg.latent_size, cfg.channels,
                      generator=gen)
    return StadiPipeline(cfg, params, sampler.linear_schedule(1000), config,
                         device=device).generate(x_T, torch.tensor([3]))


def _shared_card_rank(ctx, config):
    res = _tiny_generate(config, ctx.device)
    return res.image.cpu(), res.kernel_stats["launches"]


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_scale", [0.0, 4.0])
def test_spmd_two_gloo_ranks_on_one_card_match_cpu(cuda, cfg_scale):
    """run_spmd on 2 gloo ranks sharing the card (K1, K2, and K3 when
    guided) against the emulated image on the CPU (plain versions)."""
    from repro_torch.core.pipeline import StadiConfig
    from repro_torch.launch import ranks

    config = StadiConfig.from_occupancies([0.0, 0.5], m_base=8, m_warmup=2,
                                          cfg_scale=cfg_scale, backend="spmd")
    out = ranks.spawn(_shared_card_rank, 2, device_type="cuda",
                      dist_backend="gloo", args=(config,), timeout=600)
    want = _tiny_generate(dataclasses.replace(config, backend="emulated"),
                          "cpu").image
    for img, launches in out:
        assert ((img - want).norm() / want.norm()).item() < 1e-3
        assert launches["stale_kv_attention_padded"] > 0
        assert ("cfg_epilogue" in launches) == (cfg_scale > 0)
    assert out[0][1]["stale_kv_attention_padded"] == \
        2 * out[1][1]["stale_kv_attention_padded"]      # ratios [1, 2]


# ----------------------------------------------------------------------
# K4: one ring segment with its LSE (spmd_seq's hops)
# ----------------------------------------------------------------------

# (valid_len) of sdxl-dit's spmd_seq hops at S = 2 (segments of 3200 rows of
# a 6400-row buffer holding 4096 real keys), an empty segment (S = 4) and a
# length aligned to no tile
K4_VALIDS = [3200, 896, 0, 1001]
K4_SQ, K4_HS, K4_T = 4608, 8, 3200


def _k4_inputs(dtype, device, seed=5):
    """q [1, 4608, 8, 72]; k and v the second head group of a [1, 3200, 16,
    72] segment (strided views, as the ring reads them)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = (QK_STD * torch.randn(1, K4_SQ, K4_HS, 72, generator=g)).to(dtype)
    hold = torch.randn(2, 1, K4_T, 2 * K4_HS, 72, generator=g)
    hold[0] *= QK_STD
    hold = hold.to(dtype).to(device)
    return q.to(device), hold[0][:, :, K4_HS:], hold[1][:, :, K4_HS:]


def _k4_faults(q, k, v, valid):
    """Planted faults from the plain version: valid_len ignored, the segment
    shifted by one 64-key tile (zeros past its end), the LSE without its
    log l term (the row max alone)."""
    shift = lambda t: torch.cat([t[:, TILE:], torch.zeros_like(t[:, :TILE])], 1)
    want_out, want_lse = ref.lse_attention_ref(q, k, v, valid)
    faults = [ref.lse_attention_ref(q, k, v, k.shape[1]),
              ref.lse_attention_ref(q, shift(k), shift(v), valid)]
    if valid:
        s = torch.einsum("bshd,bthd->bsht", q.float(), k[:, :valid].float())
        faults.append((want_out, s.amax(-1) * q.shape[-1] ** -0.5))
    return faults


def _k4_within_bars(out, lse, want, dtype):
    return _within_bars(out, want[0], dtype) and _within_bars(lse, want[1],
                                                              torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid", K4_VALIDS)
def test_k4_kernel_matches_plain_and_rejects_faults(cuda, valid, dtype):
    q, k, v = _k4_inputs(dtype, cuda)
    ops.reset_launch_counts()
    out, lse = ops.lse_attention(q, k, v, valid)
    assert ops.launch_counts() == {"lse_attention": 1}
    want = ref.lse_attention_ref(q, k, v, valid)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == dtype
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    if valid == 0:                  # an empty segment: zero merge weight
        assert torch.equal(out, torch.zeros_like(out))
        assert torch.equal(lse, want[1]) and lse.max().item() <= -1e29
        return
    _assert_within_bars(out, want[0], dtype)
    _assert_within_bars(lse, want[1], torch.float32)
    for bad in _k4_faults(q, k, v, valid):
        moved = max(((b.float() - w.float()).norm() / w.float().norm()).item()
                    for b, w in zip(bad, want))
        if moved >= 1e-6:
            assert not _k4_within_bars(out, lse, bad, dtype)


# ----------------------------------------------------------------------
# edges of the key runs (K1, K2, K4, K5 share one body per dtype)
# ----------------------------------------------------------------------

# (kernel, layout): K1 (N, Nl, tok_start), K2 and K5 (n_tokens, Npad, Nl_max,
# tok_start, valid_tokens), K4 (T, valid_len). With 128-key tiles each
# layout puts a tile across a run boundary: K1 at 300 | 500 (and the patch
# at the end of a context of no tile multiple), K2 with valid_tokens below
# the slab, n_tokens cutting the slab and valid 0, K4 lengths one key on
# either side of a tile.
RUN_EDGES = [("k1", (1024, 200, 300)), ("k1", (1000, 130, 870)),
             ("k1", (1024, 1024, 0)),
             ("k2", (1000, 1280, 256, 300, 200)), ("k2", (1000, 1280, 256, 900, 256)),
             ("k2", (1000, 1280, 256, 0, 0)),
             ("k4", (640, 129)), ("k4", (640, 127)), ("k4", (640, 1)),
             ("k5", (1000, 1280, 256, 300, 200))]


def _run_edge(kind, layout, dtype, hd, device):
    """(kernel output, plain output) on strided views: K1/K2/K5's q, k, v
    slices of a fused projection and stale K/V one layer of a
    branch-stacked buffer at batch 2; K4's k, v the second head group of a
    wider segment."""
    g = torch.Generator(device="cpu").manual_seed(RUN_EDGES.index((kind, layout)) + hd)
    H = 4

    def mk(*shape, std=1.0):
        return (std * torch.randn(*shape, generator=g)).to(dtype).to(device)

    if kind == "k4":
        T, valid = layout
        q = mk(1, 300, H, hd, std=QK_STD)
        seg_k, seg_v = mk(1, T, 2 * H, hd, std=QK_STD), mk(1, T, 2 * H, hd)
        k, v = seg_k[:, :, H:], seg_v[:, :, H:]
        out, lse = ops.lse_attention(q, k, v, valid)
        want, want_lse = ref.lse_attention_ref(q, k, v, valid)
        _assert_within_bars(lse, want_lse, torch.float32)
        return out, want
    if kind == "k1":
        N, Nl, tok = layout
        rows = N
    else:
        n_tokens, rows, Nl, tok, valid = layout
    lead = 2 if kind == "k5" else 1          # K5: the branch axis over batch 1
    qkv = mk(lead, 2 // lead, Nl, 3, H, hd, std=QK_STD).flatten(0, 1)
    q, kf, vf = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    buf_k, buf_v = mk(2, 3, 1, rows, H, hd, std=QK_STD), mk(2, 3, 1, rows, H, hd)
    ks = buf_k.transpose(0, 1).flatten(1, 2)[1]
    vs = buf_v.transpose(0, 1).flatten(1, 2)[1]
    assert not ks.is_contiguous() and not q.is_contiguous()
    if kind == "k1":
        return (ops.stale_kv_attention(q, kf, vf, ks, vs, tok_start=tok),
                ref.stale_kv_attention_ref(q, kf, vf, ks, vs, tok))
    if kind == "k2":
        return (ops.stale_kv_attention_padded(q, kf, vf, ks, vs, tok, valid,
                                              n_tokens=n_tokens),
                ref.stale_kv_attention_padded_ref(q, kf, vf, ks, vs, tok, valid,
                                                  n_tokens))
    args = [t.unflatten(0, (2, 1)) for t in (q, kf, vf, ks, vs)]
    outs = []
    for uncond_fresh in (0, 1):
        outs.append((ops.stale_kv_attention_guided(*args, tok, valid, uncond_fresh,
                                                   n_tokens=n_tokens),
                     ref.stale_kv_attention_guided_ref(*args, tok, valid,
                                                       uncond_fresh, n_tokens)))
    return torch.stack([o for o, _ in outs]), torch.stack([w for _, w in outs])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 72])
@pytest.mark.parametrize("kind,layout", RUN_EDGES, ids=str)
def test_key_run_edges_match_plain(cuda, kind, layout, hd, dtype):
    out, want = _run_edge(kind, layout, dtype, hd, cuda)
    torch.cuda.synchronize()
    assert out.shape == want.shape and out.dtype == dtype
    _assert_within_bars(out, want, dtype)


def _seq_rank(ctx, config):
    res = _tiny_generate(config, ctx.device)
    return res.image.cpu(), res.kernel_stats["launches"]


@pytest.mark.cuda
def test_spmd_seq_four_gloo_ranks_on_one_card_match_cpu(cuda):
    """run_spmd_seq at S = 2 on 2 x 2 gloo ranks sharing the card (K1 for the
    warm-ups, K4 for every buffered read, no K2) against the emulated image
    on the CPU."""
    from repro_torch.core.pipeline import StadiConfig
    from repro_torch.launch import ranks

    config = StadiConfig.from_occupancies([0.0, 0.5], m_base=8, m_warmup=2,
                                          seq_shards=2, exchange="ring",
                                          backend="spmd_seq")
    out = ranks.spawn(_seq_rank, 4, device_type="cuda", dist_backend="gloo",
                      args=(config,), timeout=600)
    want = _tiny_generate(dataclasses.replace(config, backend="emulated"),
                          "cpu").image
    for img, launches in out:
        assert ((img - want).norm() / want.norm()).item() < 1e-3
        assert launches["lse_attention"] > 0
        assert "stale_kv_attention_padded" not in launches
    assert [o[1]["lse_attention"] for o in out] == \
        [out[0][1]["lse_attention"], out[0][1]["lse_attention"] // 2] * 2


# ----------------------------------------------------------------------
# kernels K6 (flash attention) and K7 (selective scan): Hymba-1.5B serving
# ----------------------------------------------------------------------

# (causal, window, prefix_len) at Hymba-1.5B's prefill shapes (q [1, 2048,
# 25, 64], k/v [1, 2048, 5, 64]): causal only, causal + window, and the
# path's window + meta-token prefix
K6_MASKS = [(True, 0, 0), (True, 1024, 0), (True, 1024, 128)]


def _k6_inputs(dtype, device, S=2048, H=25, K=5, seed=7):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = QK_STD * torch.randn(1, S, H, 64, generator=g)
    k = QK_STD * torch.randn(1, S, K, 64, generator=g)
    v = torch.randn(1, S, K, 64, generator=g)
    return [t.to(dtype).to(device) for t in (q, k, v)]


def _k6_faults(q, k, v, causal, window, prefix):
    """K6's output under planted faults, from its plain version: the prefix
    ignored, the window one key wider, KV head h % K for query head h."""
    H, K = q.shape[2], k.shape[2]
    wrong = [h % K for h in range(H)]
    faults = {"kv head h % K": ref.flash_attention_ref(
        q, k[:, :, wrong], v[:, :, wrong], causal=causal, window=window,
        prefix_len=prefix)}
    if window:
        faults["window + 1"] = ref.flash_attention_ref(
            q, k, v, causal=causal, window=window + 1, prefix_len=prefix)
    if prefix:
        faults["prefix ignored"] = ref.flash_attention_ref(
            q, k, v, causal=causal, window=window)
    return faults


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,prefix", K6_MASKS)
def test_k6_kernel_matches_plain_and_rejects_faults(cuda, causal, window,
                                                    prefix, dtype):
    q, k, v = _k6_inputs(dtype, cuda)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              prefix_len=prefix)
    assert ops.launch_counts() == {"flash_attention": 1}
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   prefix_len=prefix)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == dtype
    _assert_within_bars(out, want, dtype)
    for name, bad in _k6_faults(q, k, v, causal, window, prefix).items():
        assert not _within_bars(out, bad, dtype), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T,causal,window,prefix", [
    (200, 200, True, 48, 8), (130, 130, True, 0, 0), (96, 160, False, 40, 0),
    (160, 96, True, 0, 0), (75, 75, False, 0, 0), (300, 300, True, 100, 200),
    (400, 400, True, 64, 130), (384, 384, True, 200, 0),
    (520, 520, True, 300, 16)])
def test_k6_kernel_ragged_and_unaligned_masks(cuda, S, T, causal, window,
                                              prefix, dtype):
    """Lengths aligned to no tile, S != T, non-causal windows, a prefix
    overlapping the window (longer than it, or reaching past a tile), and
    window edges in the middle of a 128-key tile."""
    g = torch.Generator(device="cpu").manual_seed(8)
    q = (QK_STD * torch.randn(2, S, 4, 64, generator=g)).to(dtype).to(cuda)
    k = (QK_STD * torch.randn(2, T, 2, 64, generator=g)).to(dtype).to(cuda)
    v = torch.randn(2, T, 2, 64, generator=g).to(dtype).to(cuda)
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              prefix_len=prefix)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   prefix_len=prefix)
    _assert_within_bars(out, want, dtype)


@pytest.mark.cuda
def test_k6_tile_classes_match_library(cuda):
    """The bf16 body's own classification of each key tile (the C entry
    point runs the kernel's functions) is the Python mirror's, which the CPU
    tests hold to the mask."""
    from repro_torch.kernels import flash_attention as fa
    lib = ops.load_library().lib
    for hd in fa.SUPPORTED_HEAD_DIMS:
        for S, T in [(2048, 2048), (200, 200), (96, 160), (160, 96), (129, 257)]:
            for causal, window, prefix in [(True, 1024, 128), (True, 0, 0),
                                           (True, 100, 200), (False, 40, 0),
                                           (True, 64, 130)]:
                want = fa.tile_classes(S, T, causal, window, prefix,
                                       k_tile=fa.key_tile(hd))
                got = [[lib.flash_attention_tile_class(hd, S, T, int(causal),
                                                       window, prefix, qt, kt)
                        for kt in range(len(row))] for qt, row in enumerate(want)]
                assert got == want, (hd, S, T, causal, window, prefix)
    assert lib.flash_attention_tile_class(96, 64, 64, 1, 0, 0, 0, 0) == -1


def _k7_inputs(S, device, B=1, Di=1600, N=16, seed=9):
    """x, dt (a softplus, as Mamba's delta), B_t and C_t as strided halves
    of one [B, S, 2N] projection, A (negative), D, and a nonzero h0."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(B, S, Di, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, S, Di, generator=g) - 2)
    bc = torch.randn(B, S, 2 * N, generator=g)
    a = -torch.exp(0.5 * torch.randn(Di, N, generator=g))
    d = torch.randn(Di, generator=g)
    h0 = torch.randn(B, Di, N, generator=g)
    x, dt, bc, a, d, h0 = (t.to(device) for t in (x, dt, bc, a, d, h0))
    return x, dt, bc[..., :N], bc[..., N:], a, d, h0


def _k7_faults(x, dt, b, c, a, d, h0, tile=64):
    """K7's (y, h_final) under planted faults, from its plain versions: h0
    ignored, the state reset at the first 64-step tile boundary, the D x
    skip dropped, and at the scan body's first chunk boundary the carry
    dropped or entering without its decay."""
    faults = {"d x dropped": ref.ssm_scan_ref(x, dt, b, c, a,
                                              torch.zeros_like(d), h0)}
    if h0 is not None:
        faults["h0 ignored"] = ref.ssm_scan_ref(x, dt, b, c, a, d)
    if x.shape[1] > tile:
        head = ref.ssm_scan_ref(*(t[:, :tile] for t in (x, dt, b, c)), a, d, h0)
        tail = ref.ssm_scan_ref(*(t[:, tile:] for t in (x, dt, b, c)), a, d)
        faults["state reset at a tile"] = (torch.cat([head[0], tail[0]], 1),
                                           tail[1])
    chunk = ops.ss.SCAN_CHUNK
    if x.shape[1] > chunk:
        for fault in ref.SCAN_FAULTS:
            faults[fault] = ref.ssm_scan_chunked_ref(x, dt, b, c, a, d, h0,
                                                     chunk=chunk, fault=fault)
    return faults


def _k7_within_bars(y, h, want):
    return (_within_bars(y, want[0], torch.float32)
            and _within_bars(h, want[1], torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2048, 1])
@pytest.mark.parametrize("with_h0", [False, True])
def test_k7_kernel_matches_plain_and_rejects_faults(cuda, S, with_h0):
    """Hymba-1.5B's Mamba branch: prefill S 2048 and decode S 1, Di 1600,
    N 16, fp32, from zero and from a nonzero state."""
    x, dt, b, c, a, d, h0 = _k7_inputs(S, cuda)
    h0 = h0 if with_h0 else None
    ops.reset_launch_counts()
    y, h = ops.ssm_scan(x, dt, b, c, a, d, h0=h0, final_state=True)
    assert ops.launch_counts() == {"ssm_scan": 1}
    want = ref.ssm_scan_ref(x, dt, b, c, a, d, h0)
    torch.cuda.synchronize()
    assert y.shape == x.shape and h.shape == (1, 1600, 16)
    _assert_within_bars(y, want[0], torch.float32)
    _assert_within_bars(h, want[1], torch.float32)
    torch.testing.assert_close(ops.ssm_scan(x, dt, b, c, a, d, h0=h0), y,
                               rtol=0, atol=0)
    for name, bad in _k7_faults(x, dt, b, c, a, d, h0).items():
        assert not _k7_within_bars(y, h, bad), name


@pytest.mark.cuda
@pytest.mark.parametrize("S", [16, 17, 127, 128, 129, 600])
def test_k7_kernel_chunk_edges(cuda, S):
    """Both bodies around their switch (the sequential one up to S 16) and
    the scan body around its 128-step chunk, at 2 batch rows and a channel
    count that fills no block, from a nonzero state; the chunk-boundary
    faults are rejected."""
    x, dt, b, c, a, d, h0 = _k7_inputs(S, cuda, B=2, Di=200)
    y, h = ops.ssm_scan(x, dt, b, c, a, d, h0=h0, final_state=True)
    want = ref.ssm_scan_ref(x, dt, b, c, a, d, h0)
    torch.cuda.synchronize()
    _assert_within_bars(y, want[0], torch.float32)
    _assert_within_bars(h, want[1], torch.float32)
    for name, bad in _k7_faults(x, dt, b, c, a, d, h0).items():
        assert not _k7_within_bars(y, h, bad), name


@pytest.mark.cuda
def test_k7_kernel_bf16_inputs_and_ragged_channels(cuda):
    """bf16 x, dt, B, C (the output in bf16) and a channel count that fills
    no block."""
    x, dt, b, c, a, d, h0 = _k7_inputs(100, cuda, B=2, Di=200)
    args = [t.to(torch.bfloat16) for t in (x, dt, b, c)]
    y, h = ops.ssm_scan(*args, a, d, h0=h0, final_state=True)
    want = ref.ssm_scan_ref(*args, a, d, h0)
    assert y.dtype == torch.bfloat16
    _assert_within_bars(y, want[0], torch.bfloat16)
    _assert_within_bars(h, want[1], torch.float32)


@pytest.mark.cuda
def test_k6_k7_wrappers_refuse(cuda):
    """Unsupported head dims, state sizes and dtypes raise; nothing falls
    back to the plain version."""
    q, k, v = _k6_inputs(torch.bfloat16, cuda, S=64, H=4, K=2)
    with pytest.raises(ValueError, match="head dim 32 not instantiated"):
        ops.flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                            v[..., :32].contiguous())
    ops.reset_launch_counts()
    for hd in (96, 192):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(hd)
            q, k, v = (torch.randn(1, 64, 2, hd, generator=g).to(dtype).to(cuda)
                       for _ in range(3))
            with pytest.raises(ValueError, match=f"head dim {hd} not instantiated"):
                ops.flash_attention(q, k, v)
    assert ops.launch_counts() == {}
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        ops.flash_attention(q.half(), k.half(), v.half())
    x, dt, b, c, a, d, h0 = _k7_inputs(8, cuda, Di=32)
    with pytest.raises(ValueError, match="state size 8 not instantiated"):
        ops.ssm_scan(x, dt, b[..., :8], c[..., :8], a[:, :8].contiguous(), d)
    with pytest.raises(ValueError, match="all be float32 or all"):
        ops.ssm_scan(x.half(), dt.half(), b.half(), c.half(), a, d)
    with pytest.raises(ValueError, match="a, d_skip and h0 must be float32"):
        ops.ssm_scan(x, dt, b, c, a.bfloat16(), d)


@pytest.mark.cuda
def test_hymba_serving_on_card_matches_cpu(cuda):
    """hymba-1.5b reduced (GQA 4/2) in fp32 through prefill and 6 decode
    steps (a prompt past the ring): the card's logits (K6, K7) against the
    CPU's (the plain versions), relative 1e-4, and the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, hymba

    cfg = get_config("hymba-1.5b").reduced().replace(n_kv_heads=2)
    params = hymba.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab, (1, 96),
                           generator=torch.Generator().manual_seed(1))
    model = build_model(cfg)
    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}
    logits = {}
    for dev in ("cpu", cuda):
        p = to(params, dev)
        cache = model.init_cache(1, 0, window=cfg.sliding_window, device=dev)
        out, cache = model.prefill(p, {"tokens": tokens.to(dev)}, cache,
                                   window=cfg.sliding_window)
        seq = [out.cpu()]
        for tok in (3, 14, 15, 92, 65, 35):
            out, cache = model.decode_step(p, cache, torch.tensor([tok], device=dev),
                                           window=cfg.sliding_window)
            seq.append(out.cpu())
        logits[str(dev)] = torch.stack(seq)
    want, got = logits["cpu"], logits[str(cuda)]
    assert ((got - want).norm() / want.norm()).item() < 1e-4
    assert torch.equal(got.argmax(-1), want.argmax(-1))


# q/k/v of K6 at the dense decoders' full attention shapes (S = T = 2048,
# causal): gemma-2b (8 query heads, MQA, hd 256), olmoe-1b-7b (16/16, hd
# 128) and internvl2-76b (64/8, hd 128) with its 1024 vision tokens as the
# prefix of a 1024-key window (the VLM's mask when served with a window)
K6_DECODER_SHAPES = [(8, 1, 256, 0, 0), (16, 16, 128, 0, 0),
                     (64, 8, 128, 1024, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,hd,window,prefix", K6_DECODER_SHAPES)
def test_k6_at_decoder_head_dims(cuda, H, K, hd, window, prefix, dtype):
    """K6 against its plain version at head dims 128 and 256, K1's bars
    (a peaked softmax), and each planted fault rejected."""
    g = torch.Generator(device="cpu").manual_seed(hd + H)
    q = (QK_STD * torch.randn(1, 2048, H, hd, generator=g)).to(dtype).to(cuda)
    k = (QK_STD * torch.randn(1, 2048, K, hd, generator=g)).to(dtype).to(cuda)
    v = torch.randn(1, 2048, K, hd, generator=g).to(dtype).to(cuda)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              prefix_len=prefix)
    assert ops.launch_counts() == {"flash_attention": 1}
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                   prefix_len=prefix)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == dtype
    _assert_within_bars(out, want, dtype)
    faults = _k6_faults(q, k, v, True, window, prefix)
    faults["last 64 columns dropped"] = torch.cat(
        [want[..., :hd - 64], torch.zeros_like(want[..., hd - 64:])], -1)
    faults["keys shifted one place"] = ref.flash_attention_ref(
        q, k.roll(1, dims=1), v.roll(1, dims=1), causal=True, window=window,
        prefix_len=prefix)
    if K > 1:
        wrong = [(h + 1) % K for h in range(K)]
        faults["kv head (h + 1) % K"] = ref.flash_attention_ref(
            q, k[:, :, wrong], v[:, :, wrong], causal=True, window=window,
            prefix_len=prefix)
    hidden = ref.flash_mask(2048, 2048, causal=True, window=window,
                            prefix_len=prefix, device=cuda)
    hidden[:, :TILE] = False
    faults["first 64 keys hidden"] = layers.attend(
        q.float(), k.float(), v.float(), mask=hidden[None, None]).to(dtype)
    # a fault that computes the same function at this shape (KV head h % K
    # under MQA or MHA, a wider window that no row reaches) shows nothing
    moved = {name: bad for name, bad in faults.items()
             if ((bad.float() - want.float()).norm() / want.float().norm()) > 1e-6}
    assert len(moved) >= 3, sorted(moved)
    for name, bad in moved.items():
        assert not _within_bars(out, bad, dtype), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [128, 256])
def test_k6_decoder_head_dims_ragged(cuda, hd, dtype):
    """Lengths aligned to no tile (of 128 keys, or 64 at hd 256), S != T, a
    window edge inside a tile and a prefix reaching past one."""
    g = torch.Generator(device="cpu").manual_seed(hd)
    for S, T, causal, window, prefix in [(200, 200, True, 48, 8),
                                         (96, 160, False, 40, 0),
                                         (300, 300, True, 100, 200),
                                         (520, 520, True, 300, 16)]:
        q = (QK_STD * torch.randn(2, S, 4, hd, generator=g)).to(dtype).to(cuda)
        k = (QK_STD * torch.randn(2, T, 2, hd, generator=g)).to(dtype).to(cuda)
        v = torch.randn(2, T, 2, hd, generator=g).to(dtype).to(cuda)
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  prefix_len=prefix)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       prefix_len=prefix)
        _assert_within_bars(out, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,window", [("gemma-2b", 0), ("olmoe-1b-7b", 0),
                                         ("internvl2-76b", 24)])
def test_decoders_on_card_match_cpu(cuda, arch, window):
    """The reduced decoders in fp32 through prefill and 4 decode steps (the
    VLM past its pinned ring): the card's logits (K6) against the CPU's (the
    plain version), relative 1e-4, and the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced().replace(dtype="float32",
                                             param_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = model.make_batch(torch.Generator().manual_seed(1), 1, 40)

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}
    logits = {}
    for dev in ("cpu", cuda):
        p = to(params, dev)
        cache = model.init_cache(1, 64, window=window, device=dev)
        out, cache = model.prefill(p, to(batch, dev), cache, window=window)
        seq = [out.cpu()]
        for tok in (3, 14, 15, 92):
            out, cache = model.decode_step(p, cache, torch.tensor([tok], device=dev),
                                           window=window)
            seq.append(out.cpu())
        logits[str(dev)] = torch.stack(seq)
    want, got = logits["cpu"], logits[str(cuda)]
    assert ((got - want).norm() / want.norm()).item() < 1e-4
    assert torch.equal(got.argmax(-1), want.argmax(-1))


# ----------------------------------------------------------------------
# the displaced stage chain and the multi-rank serving lanes
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,first", [(2, 1), (4, 0)])
@pytest.mark.parametrize("N,Nl,tok_start", MAIN_PATH_CASES[:2])
def test_k1_at_pipefuse_lane_batches(cuda, N, Nl, tok_start, G, first, dtype):
    """K1 over G lanes of the pipefuse stepper: the stale K/V the slot-range
    view of one layer of the [L, slots, N, H, hd] displaced contexts, read
    in place; the bars, and the planted faults rejected."""
    g = torch.Generator(device="cpu").manual_seed(G + first)

    def mk(*shape, std=1.0):
        return (std * torch.randn(*shape, generator=g)).to(dtype).to(cuda)
    ctx_k, ctx_v = mk(2, 4, N, 16, 72, std=QK_STD), mk(2, 4, N, 16, 72)
    ks, vs = ctx_k[1, first:first + G], ctx_v[1, first:first + G]
    q, kf, vf = mk(G, Nl, 16, 72, std=QK_STD), mk(G, Nl, 16, 72, std=QK_STD), \
        mk(G, Nl, 16, 72)
    ops.reset_launch_counts()
    out = ops.stale_kv_attention(q, kf, vf, ks, vs, tok_start=tok_start)
    assert ops.launch_counts() == {"stale_kv_attention": 1}
    want = ref.stale_kv_attention_ref(q, kf, vf, ks, vs, tok_start)
    torch.cuda.synchronize()
    _assert_within_bars(out, want, dtype)
    skipped = ks.clone(), vs.clone()
    skipped[0][:, tok_start:tok_start + Nl] = kf
    skipped[1][:, tok_start:tok_start + Nl] = vf
    keep = torch.ones(1, 1, 1, N, dtype=torch.bool, device=cuda)
    keep[..., N - TILE:] = False
    bad = layers.attend(q.float(), skipped[0].float(), skipped[1].float(),
                        mask=keep).to(dtype)
    assert not _within_bars(out, bad, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tok,valid", K2_LAYOUTS[:2])
def test_k2_at_spmd_cohort_batch(cuda, tok, valid, dtype):
    """K2 over a cohort of 4 lanes of the spmd stepper at the rank layouts:
    the bars, and the planted faults rejected."""
    args = _k2_inputs(dtype, cuda, 4)
    out = ops.stale_kv_attention_padded(*args, tok, valid, n_tokens=K2_N)
    want = ref.stale_kv_attention_padded_ref(*args, tok, valid, K2_N)
    torch.cuda.synchronize()
    _assert_within_bars(out, want, dtype)
    _assert_rejects_faults(out, want, _k2_faults(
        ref.stale_kv_attention_padded_ref, args, tok, valid), dtype)


def _tiny_chain(device):
    from repro_torch.configs import get_config
    from repro_torch.models.diffusion import dit

    cfg = get_config("tiny-dit").reduced()
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = dit.nondegenerate_params(dit.init_params(gen, cfg), gen)
    x_T = torch.randn(1, cfg.latent_size, cfg.latent_size, cfg.channels,
                      generator=gen)
    return cfg, params, x_T


@pytest.mark.cuda
def test_guided_displaced_step_one_k3_launch_with_delta(cuda):
    """The guided displaced step takes ONE K3 launch, with the delta, and
    its combined eps and delta are what K3's plain version gives for the
    step's own branch outputs; card against CPU within 1e-4."""
    from repro_torch.core import pipefuse
    from repro_torch.core.pipeline import _to_device

    cfg, params, x_T = _tiny_chain(cuda)
    L, H = cfg.n_layers, cfg.n_heads
    g = torch.Generator(device="cpu").manual_seed(5)
    ctx = [torch.randn(L, 2, cfg.n_tokens, H, cfg.d_model // H, generator=g)
           for _ in range(2)]
    x = x_T[:, 2 * cfg.patch_size:5 * cfg.patch_size]
    out = {}
    for d in ("cpu", cuda):
        ops.reset_launch_counts()
        eps, delta, k2, v2, ck, cv = pipefuse.guided_displaced_step(
            _to_device(params, d), cfg, x.to(d), 40, torch.tensor([3], device=d),
            2, ctx[0].clone().to(d), ctx[1].clone().to(d), ((0, 1), (1, 2)),
            4.0)
        out[d] = (eps.cpu(), delta.cpu(), ck.cpu(), ops.launch_counts())
    assert out[cuda][3] == {"stale_kv_attention": L, "cfg_epilogue": 1}
    for a, b in zip(out[cuda][:3], out["cpu"][:3]):
        assert ((a - b).norm() / b.norm()).item() < 1e-4


@pytest.mark.cuda
def test_pipefuse_one_stage_bitwise_emulated_on_card(cuda):
    """On the card too, the pipefuse backend at one stage is the emulated
    backend bitwise; at two stages its launches follow the trace."""
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiConfig, StadiPipeline

    cfg, params, x_T = _tiny_chain(cuda)
    base = StadiConfig.from_occupancies([0.0, 0.5], m_base=8, m_warmup=2)
    res = {}
    for label, knobs in (("emulated", {}), ("one", dict(backend="pipefuse")),
                         ("two", dict(backend="pipefuse", num_stages=2))):
        res[label] = StadiPipeline(
            cfg, params, sampler.linear_schedule(1000),
            dataclasses.replace(base, **knobs), device=cuda).generate(
                x_T, torch.tensor([3]))
    assert torch.equal(res["one"].image, res["emulated"].image)
    trace = res["two"].trace
    evals = sum(1 if e.synchronous else sum(e.substeps) for e in trace.events)
    assert res["two"].kernel_stats["launches"] == {
        "stale_kv_attention": cfg.n_layers * evals}


# ----------------------------------------------------------------------
# the frame axis: K1 and K2 over a video frame's 2N context
# ----------------------------------------------------------------------

#: a frame f > 0 reads its own 4096 published rows and frame f-1's; K1's
#: (Nl, tok_start) and K2's (Nl_max, tok_start, valid_tokens) at the video
#: paths' layouts (chip_smoke.py phase_ctx2n)
CTX_N = 8192
K1_CTX_CASES = [(2304, 0), (1792, 2304), (4096, 0), (2048, 2048), (200, 72)]
K2_CTX_LAYOUTS = [(2048, 0, 2048), (2048, 2048, 2048), (2304, 2304, 1792)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Nl,tok_start", K1_CTX_CASES)
def test_k1_over_the_2n_context_matches_plain(cuda, Nl, tok_start, dtype):
    """K1 with its stale K/V the ``torch.cat`` of two frames' 4096 rows, as
    the video path builds it; dropping the previous frame's half is outside
    the bars."""
    q, kf, vf, own_k, own_v = _inputs(CTX_N // 2, Nl, dtype, cuda, seed=5)
    _, _, _, prev_k, prev_v = _inputs(CTX_N // 2, 1, dtype, cuda, seed=6)
    ks, vs = torch.cat([own_k, prev_k], 1), torch.cat([own_v, prev_v], 1)
    out = ops.stale_kv_attention(q, kf, vf, ks, vs, tok_start=tok_start)
    want = ref.stale_kv_attention_ref(q, kf, vf, ks, vs, tok_start)
    torch.cuda.synchronize()
    _assert_within_bars(out, want, dtype)
    _assert_rejects_faults(out, want, [ref.stale_kv_attention_ref(
        q, kf, vf, own_k, own_v, tok_start)], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nl,tok,valid", K2_CTX_LAYOUTS)
def test_k2_with_2n_tokens_matches_plain(cuda, nl, tok, valid, dtype):
    """K2 with n_tokens two frames' worth over a buffer of 2N + Nl_max rows;
    the faults of K2 and n_tokens of one frame are outside the bars."""
    g = torch.Generator(device="cpu").manual_seed(7)

    def mk(n, std):
        return (std * torch.randn(1, n, 16, 72, generator=g)).to(dtype).to(cuda)
    args = (mk(nl, QK_STD), mk(nl, QK_STD), mk(nl, 1.0),
            mk(CTX_N + nl, QK_STD), mk(CTX_N + nl, 1.0))
    plain = ref.stale_kv_attention_padded_ref
    out = ops.stale_kv_attention_padded(*args, tok, valid, n_tokens=CTX_N)
    want = plain(*args, tok, valid, CTX_N)
    torch.cuda.synchronize()
    _assert_within_bars(out, want, dtype)
    _assert_rejects_faults(out, want, [
        plain(*args, tok, nl, CTX_N), plain(*args, tok, valid, CTX_N + nl),
        plain(*args, tok + TILE, valid, CTX_N),
        plain(*args, tok, valid, CTX_N // 2)], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_scale", [0.0, 4.0])
def test_video_frame_zero_is_bitwise_the_image_on_the_card(cuda, cfg_scale):
    """tiny-dit.reduced() in fp32, a 3-frame video on the card: frame 0
    bitwise the image path's, K1 once a layer of every eval of every frame,
    and the video within 1e-3 of the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiConfig, StadiPipeline
    from repro_torch.models.diffusion import dit

    cfg = get_config("tiny-dit").reduced()
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = dit.nondegenerate_params(dit.init_params(gen, cfg), gen)
    video = torch.randn(1, 3, cfg.latent_size, cfg.latent_size, cfg.channels,
                        generator=gen)
    cond = torch.tensor([3])
    config = StadiConfig.from_occupancies([0.0, 0.5], m_base=8, m_warmup=2,
                                          exchange="stale_async",
                                          cfg_scale=cfg_scale, num_frames=3)
    sched = sampler.linear_schedule(1000)
    vid = {d: StadiPipeline(cfg, params, sched, config, device=d).generate(
        video, cond) for d in ("cpu", cuda)}
    image = StadiPipeline(cfg, params, sched, dataclasses.replace(
        config, num_frames=1), device=cuda).generate(video[:, 0], cond).image
    assert torch.equal(vid[cuda].image[:, 0], image)
    got, want = vid[cuda].image.cpu(), vid["cpu"].image
    assert ((got - want).norm() / want.norm()).item() < 1e-3
    evals = sum((1 if e.synchronous else sum(e.substeps)) * e.frames
                for e in vid[cuda].trace.events)
    launches = vid[cuda].kernel_stats["launches"]
    assert launches["stale_kv_attention"] == cfg.n_layers * evals
    assert launches.get("cfg_epilogue", 0) == (evals if cfg_scale else 0)


# ----------------------------------------------------------------------
# prompt conditioning: the frozen text encoder and the prompt read
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tiny-dit", "sdxl-dit"])
def test_text_encoder_on_card_matches_cpu(cuda, arch):
    """The frozen tower is drawn on the CPU and moved, so the card and the
    CPU hold the same weights; their tokens agree within fp32 rounding, and
    the padding is zero in every channel on both."""
    from repro_torch.configs import get_config
    from repro_torch.models import text_encoder

    cfg = get_config(arch).text_conditioned(cond_seq_len=32)
    prompts = ["a red fox in the deep snow", "whale song"]
    a = text_encoder.encode(prompts, cfg, device="cpu")
    b = text_encoder.encode(prompts, cfg, device=cuda)
    assert b.device.type == "cuda" and b.shape == a.shape == (2, 8, cfg.cond_dim + 1)
    assert (b.cpu() - a).abs().max().item() < 1e-4
    assert torch.equal(b[1, 2:].cpu(), torch.zeros_like(a[1, 2:]))


@pytest.mark.cuda
def test_null_prompt_read_is_exactly_zero_in_bf16(cuda):
    """sdxl-dit width in bf16: one block's cross-attention read of the
    all-zero null sequence adds exactly 0.0 (every key masked: the -1e30
    fill gives uniform weights over zero values), where a -inf fill gives
    NaN."""
    from repro_torch.configs import get_config
    from repro_torch.models import text_encoder
    from repro_torch.models.diffusion import dit

    cfg = get_config("sdxl-dit").replace(n_layers=1).text_conditioned(32)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = dit.nondegenerate_params(dit.init_params(gen, cfg), gen)
    blk = {k: v[0] for k, v in params["blocks"].items()}
    h = torch.randn(2, 256, cfg.d_model, device=cuda,
                    generator=gen).to(torch.bfloat16)
    null = text_encoder.null_cond(2, 8, cfg, device=cuda)
    mask = (null[..., -1] > 0.5)[:, None, None, :]
    kv = dit._prompt_kv(params["blocks"]["xkv"], null[..., :-1], h.dtype)[0]
    assert torch.equal(dit._prompt_read(blk, h, kv, mask, cfg.n_heads), h)
    logits = torch.zeros(2, cfg.n_heads, 256, 8, device=cuda)
    assert torch.isnan(torch.softmax(logits.masked_fill(~mask, float("-inf")),
                                     -1)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_scale", [0.0, 4.0])
def test_prompt_generate_on_card_matches_cpu(cuda, cfg_scale):
    """tiny-dit.reduced().text_conditioned(8) in fp32 on a prompt: the
    card's image (K1, K3) within 1e-3 of the CPU's, K1 once a layer of
    every eval (the prompt read launches none)."""
    from repro_torch.configs import get_config
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiConfig, StadiPipeline
    from repro_torch.models import text_encoder
    from repro_torch.models.diffusion import dit

    cfg = get_config("tiny-dit").reduced().text_conditioned(cond_seq_len=8)
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = dit.nondegenerate_params(dit.init_params(gen, cfg), gen)
    x_T = torch.randn(1, cfg.latent_size, cfg.latent_size, cfg.channels,
                      generator=gen)
    tok = text_encoder.encode(["a red fox"], cfg, device="cpu")
    config = StadiConfig.from_occupancies([0.0, 0.5], m_base=8, m_warmup=2,
                                          cfg_scale=cfg_scale)
    res = {d: StadiPipeline(cfg, params, sampler.linear_schedule(1000), config,
                            device=d).generate(x_T, tok) for d in ("cpu", cuda)}
    got, want = res[cuda].image.cpu(), res["cpu"].image
    assert ((got - want).norm() / want.norm()).item() < 1e-3
    evals = sum(1 if e.synchronous else sum(e.substeps)
                for e in res[cuda].trace.events)
    assert res[cuda].kernel_stats["launches"]["stale_kv_attention"] == \
        cfg.n_layers * evals


#: six prompt requests on 4 slots: (cfg_scale, round submitted before,
#: prompt) of buckets 8, 8, 4, 32, 4, 32 (chip_smoke.py's PROMPT_TRAFFIC)
PROMPT_LANES = [
    (None, 0, "a red fox in the deep snow"),
    (None, 0, "an old lighthouse on a rocky shore"),
    (3.0, 0, "fox at dusk"),
    (None, 0, " ".join(["word"] * 21)),
    (5.0, 3, "whale song"),
    (None, 3, " ".join(["night"] * 20)),
]


@pytest.mark.cuda
def test_prompt_lanes_bitwise_their_lone_generate_on_card(cuda):
    """sdxl-dit at full width and two blocks, bf16: six prompt requests of
    buckets 8, 8, 4, 32, 4, 32 (two guided) on 4 slots, each image bitwise a
    lone generate of its request (chip_smoke's diffusion_serve_prompt at
    reduced depth), K1 and K3 once a layer of each dispatch and once a
    guided dispatch."""
    from repro_torch.configs import get_config
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiConfig, StadiPipeline
    from repro_torch.models import text_encoder
    from repro_torch.models.diffusion import dit
    from repro_torch.serving import DiffusionServingEngine

    cfg = get_config("sdxl-dit").replace(n_layers=2).text_conditioned(32)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = dit.nondegenerate_params(dit.init_params(gen, cfg), gen)
    sched = sampler.linear_schedule(1000)
    config = StadiConfig.from_occupancies([0.0, 0.5], m_base=8, m_warmup=2)
    engine = DiffusionServingEngine(StadiPipeline(cfg, params, sched, config,
                                                  device=cuda), slots=4)
    subs, r = [], 0
    ops.reset_launch_counts()
    while engine.queue or engine.active or len(subs) < len(PROMPT_LANES):
        for scale, at, prompt in PROMPT_LANES:
            if at == r:
                x = torch.randn(1, cfg.latent_size, cfg.latent_size,
                                cfg.channels, generator=gen,
                                device=cuda).to(torch.bfloat16)
                tok = text_encoder.encode([prompt], cfg, device=cuda)
                subs.append((engine.submit(x, tok, cfg_scale=scale), x, tok,
                             scale))
        engine.step()
        r += 1
    assert [tok.shape[1] for _, _, tok, _ in subs] == [8, 8, 4, 32, 4, 32]
    d = engine.stats()["dispatches"]
    assert ops.launch_counts() == {
        "stale_kv_attention": cfg.n_layers * (d["plain"] + d["guided"]),
        "cfg_epilogue": d["guided"]}
    assert set(engine.stats()["dispatches_by_bucket"]) == {
        "plain/8", "plain/32", "guided/4"}
    for req, x, tok, scale in subs:
        lone = StadiPipeline(cfg, params, sched, dataclasses.replace(
            config, cfg_scale=scale or 0.0), device=cuda).generate(x, tok)
        assert torch.equal(req.image, lone.image), req.uid


# ----------------------------------------------------------------------
# K1 under autograd (the training wing) and the tensor-parallel baseline
# ----------------------------------------------------------------------

def _tiny_train_setup(dtype, device):
    """tiny-dit.reduced() nondegenerate weights in ``dtype``, a batch of 4
    with its draws, all from seeds on the CPU, moved to ``device``."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.models.diffusion import dit

    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    cfg = get_config("tiny-dit").reduced().replace(param_dtype=name, dtype=name)
    gen = torch.Generator().manual_seed(0)
    params = dit.nondegenerate_params(dit.init_params(gen, cfg), gen)
    x0 = torch.rand(4, 16, 16, 3, generator=gen) * 2 - 1
    t = torch.randint(1, 1001, (4,), generator=gen)
    eps = torch.randn(x0.shape, generator=gen)
    to = lambda a: a.to(device)
    return (cfg, tree_lib.tree_map(to, params), to(x0.to(dtype)),
            to(torch.tensor([1, 5, 9, 14])), to(t), to(eps))


def _loss_grads(cfg, params, x0, cls, t, eps):
    from repro_torch import tree as tree_lib
    from repro_torch.core import sampler
    from repro_torch.models.diffusion import dit

    p = tree_lib.tree_map(lambda a: a.detach().requires_grad_(), params)
    loss = sampler.diffusion_loss_at(
        lambda x, tt: dit.forward(p, cfg, x, tt, cls),
        sampler.linear_schedule(1000), x0, t, eps)
    return torch.autograd.grad(loss, tree_lib.leaves(p))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_function_gradients_match_plain_version(cuda, dtype, monkeypatch):
    """The loss's gradients through dit.forward with the all-fresh read in
    the K1 Function (forward: the kernel, K1 once a block) against the same
    forward through K1's plain version, norm-relative over all leaves
    within the dtype's norm bar."""
    args = _tiny_train_setup(dtype, cuda)
    ops.reset_launch_counts()
    got = _loss_grads(*args)
    assert ops.launch_counts() == {"stale_kv_attention": args[0].n_layers}
    monkeypatch.setattr(ops, "stale_kv_attention_autograd",
                        lambda q, kf, vf, ks, vs, *, tok_start:
                        ref.stale_kv_attention_ref(q, kf, vf, ks, vs, tok_start))
    want = _loss_grads(*args)
    diff = sum(float((a.float() - b.float()).square().sum())
               for a, b in zip(got, want)) ** 0.5
    norm = sum(float(b.float().square().sum()) for b in want) ** 0.5
    assert diff / norm <= NORM_BARS[dtype], diff / norm
    assert all(bool(torch.isfinite(g).all()) for g in got)


@pytest.mark.cuda
def test_k1_refuses_a_grad_operand_outside_its_function(cuda):
    q = torch.zeros(1, 64, 2, 32, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.stale_kv_attention(q, q, q, q, q, tok_start=0)
    with torch.no_grad():
        ops.stale_kv_attention(q, q, q, q, q, tok_start=0)
    out = ops.stale_kv_attention_autograd(q, q, q, q, q, tok_start=0)
    assert out.grad_fn is not None


def _tp_rank(ctx, x, cond):
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.core import tensor_parallel as tp
    from repro_torch.models.diffusion import dit

    cfg = get_config("tiny-dit").reduced()
    gen = torch.Generator().manual_seed(0)
    params = dit.nondegenerate_params(dit.init_params(gen, cfg), gen)
    shard = tree_lib.tree_map(lambda a: a.to(ctx.device), tp.shard_params(
        params, cfg, ctx.rank, ctx.world))
    ops.reset_launch_counts()
    eps = tp.tp_forward(shard, cfg, x.to(ctx.device), 50, cond.to(ctx.device))
    return eps.cpu(), ops.launch_counts()


@pytest.mark.cuda
def test_tp_step_on_two_gloo_ranks_matches_single_card(cuda):
    """tp_forward of tiny-dit.reduced() (fp32) on 2 gloo ranks sharing the
    card: K1 once a block a rank over its 2 heads, equal on both ranks,
    within 1e-5 of the single-card forward."""
    from repro_torch.configs import get_config
    from repro_torch.launch import ranks
    from repro_torch.models.diffusion import dit

    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    cond = torch.tensor([1, 2])
    out = ranks.spawn(_tp_rank, 2, device_type="cuda", dist_backend="gloo",
                      args=(x, cond), timeout=600)
    cfg = get_config("tiny-dit").reduced()
    gen = torch.Generator().manual_seed(0)
    params = dit.nondegenerate_params(dit.init_params(gen, cfg), gen)
    want = dit.forward(params, cfg, x, 50, cond)
    for eps, launches in out:
        assert launches == {"stale_kv_attention": cfg.n_layers}
        assert torch.equal(eps, out[0][0])
        torch.testing.assert_close(eps, want, rtol=0.0, atol=1e-5)


# the enc-dec LM's K6 shapes, cut to batch 1 and 4 heads of 64: (S, T) of
# the encoder, the cross read, the decode's one row, a ragged pair
K6_NONCAUSAL_CASES = [(1024, 1024), (256, 1024), (1, 1024), (250, 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T", K6_NONCAUSAL_CASES)
def test_k6_noncausal_matches_plain(cuda, S, T, dtype):
    """K6 without the causal mask (S != T, the decode's S = 1 in a 128-row
    query tile, ragged S and T) against its plain version."""
    g = torch.Generator(device="cpu").manual_seed(S + T)
    q = (QK_STD * torch.randn(1, S, 4, 64, generator=g)).to(dtype).to(cuda)
    k = (QK_STD * torch.randn(1, T, 4, 64, generator=g)).to(dtype).to(cuda)
    v = torch.randn(1, T, 4, 64, generator=g).to(dtype).to(cuda)
    out = ops.flash_attention(q, k, v, causal=False)
    assert _within_bars(out, ref.flash_attention_ref(q, k, v, causal=False), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_and_k7_functions_match_plain_gradients(cuda, dtype):
    """K6 and K7 under autograd on the card (``ops.flash_attention`` and
    ``ops.ssm_scan`` route a grad operand through their Functions): one
    launch a forward, and the gradients of every operand (K7's h0
    included, the loss reading y and the final state) within the dtype's
    norm bar of autograd of the plain versions; under ``no_grad`` the same
    calls launch outside the Functions."""
    g = torch.Generator(device="cpu").manual_seed(7)
    qkv = [(QK_STD * torch.randn(1, S, H, 64, generator=g)).to(dtype).to(cuda)
           for S, H in ((200, 4), (300, 2), (300, 2))]
    w = torch.randn(1, 200, 4, 64, generator=g).to(cuda)
    got, want = [], []
    for fn, sink in ((ops.flash_attention, got),
                     (ref.flash_attention_ref, want)):
        ins = [t.clone().requires_grad_() for t in qkv]
        ops.reset_launch_counts()
        out = fn(*ins, causal=False)
        if sink is got:
            assert ops.launch_counts() == {"flash_attention": 1}
        sink.extend(torch.autograd.grad((out.float() * w).sum(), ins))
    B, S, Di, N = 1, 300, 96, 16
    scan = [torch.randn(B, S, Di, generator=g),
            torch.nn.functional.softplus(torch.randn(B, S, Di, generator=g) - 2),
            torch.randn(B, S, N, generator=g), torch.randn(B, S, N, generator=g),
            -torch.rand(Di, N, generator=g) - 0.1, torch.rand(Di, generator=g),
            torch.randn(B, Di, N, generator=g)]
    scan = [t.to(cuda) for t in scan]
    for autograd, sink in ((True, got), (False, want)):
        ins = [t.clone().requires_grad_() for t in scan]
        ops.reset_launch_counts()
        y, h = (ops.ssm_scan(*ins[:6], h0=ins[6], final_state=True)
                if autograd else ref.ssm_scan_ref(*ins))
        if autograd:
            assert ops.launch_counts() == {"ssm_scan": 1}
        sink.extend(torch.autograd.grad(y.sum() + h.square().sum(), ins))
    for a, b in zip(got, want):
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        assert rel <= max(NORM_BARS[dtype], 5e-5), rel
    ops.reset_launch_counts()
    with torch.no_grad():
        out = ops.flash_attention(*[t.clone().requires_grad_() for t in qkv],
                                  causal=False)
        y = ops.ssm_scan(*[t.clone().requires_grad_() for t in scan[:6]])
    assert out.grad_fn is None and y.grad_fn is None
    assert ops.launch_counts() == {"flash_attention": 1, "ssm_scan": 1}
