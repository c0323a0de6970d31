"""Card-only tests of the port's CUDA kernels (marker ``cuda``): each kernel
against its plain PyTorch version at the shapes ``chip_smoke.py`` checks.
They skip on a machine without a CUDA device. No JAX here: the machine
with the card has none. Run them there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
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
