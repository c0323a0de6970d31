"""Kernel K1 (stale-KV patch attention) on the CPU: the port's plain
version against the reference's Pallas kernel (interpret mode) and the
reference's plain version, at the (N, Nl, tok_start) cases of
tests/test_kernels.py, to the kernel bar of DESIGN.md §15 (5e-5, fp32); the
wrapper's checks; and that it never falls back from the CUDA kernel to the
plain version. The kernel itself runs in tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

BAR = dict(rtol=0.0, atol=5e-5)


def _inputs(N, Nl, B=2, H=2, hd=32, seed=3):
    rng = np.random.default_rng(seed)
    mk = lambda n: (0.5 * rng.standard_normal((B, n, H, hd))).astype(np.float32)
    return mk(Nl), mk(Nl), mk(Nl), mk(N), mk(N)


@pytest.mark.parametrize("N,Nl,tok_start", [
    (256, 64, 0), (256, 64, 64), (256, 64, 192), (256, 128, 128),
    (512, 256, 256),
])
def test_plain_version_matches_reference(N, Nl, tok_start):
    arrs = _inputs(N, Nl)
    got = ops.stale_kv_attention(*map(torch.from_numpy, arrs),
                                 tok_start=tok_start).numpy()
    pallas = np.asarray(jops.stale_kv_attention(*map(jnp.asarray, arrs),
                                                tok_start=tok_start))
    bhsd = [jnp.moveaxis(jnp.asarray(a), 2, 1) for a in arrs]
    plain = np.asarray(jnp.moveaxis(jref.stale_kv_attention_ref(*bhsd, tok_start),
                                    1, 2))
    np.testing.assert_allclose(got, pallas, **BAR)
    np.testing.assert_allclose(got, plain, **BAR)


def test_unaligned_layout_and_strided_views():
    """The port takes any tok_start (the CUDA kernel selects per key row);
    the block stack passes q/k/v as views of the fused projection and the
    stale K/V as one layer of the [L,B,N,H,hd] buffer."""
    B, N, Nl, H, hd = 1, 256, 40, 2, 32
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((B, Nl, 3, H, hd)).astype(np.float32))
    buf = torch.from_numpy(rng.standard_normal((2, 3, B, N, H, hd)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = ops.stale_kv_attention(q, k, v, buf[0, 1], buf[1, 1], tok_start=72)
    want = ref.stale_kv_attention_ref(q.contiguous(), k.contiguous(),
                                      v.contiguous(), buf[0, 1].contiguous(),
                                      buf[1, 1].contiguous(), 72)
    torch.testing.assert_close(got, want, **BAR)
    full_k = buf[0, 1].clone()
    full_k[:, 72:72 + Nl] = k
    full_v = buf[1, 1].clone()
    full_v[:, 72:72 + Nl] = v
    s = torch.einsum("bshd,bthd->bhst", q, full_k) * hd ** -0.5
    dense = torch.einsum("bhst,bthd->bshd", s.softmax(-1), full_v)
    torch.testing.assert_close(got, dense, **BAR)


def test_wrapper_checks_inputs():
    q, kf, vf, ks, vs = map(torch.from_numpy, _inputs(64, 16))
    with pytest.raises(ValueError, match="outside"):
        ops.stale_kv_attention(q, kf, vf, ks, vs, tok_start=56)
    with pytest.raises(ValueError, match="fresh"):
        ops.stale_kv_attention(q, kf[:, :8], vf, ks, vs, tok_start=0)
    with pytest.raises(ValueError, match="stale"):
        ops.stale_kv_attention(q, kf, vf, ks[:, :, :1], vs, tok_start=0)


def test_no_fallback_from_the_kernel():
    """CPU tensors take the plain version and launch nothing; asking for the
    CUDA kernel without a GPU raises; a device with no kernel raises."""
    ops.reset_launch_counts()
    q, kf, vf, ks, vs = map(torch.from_numpy, _inputs(64, 16))
    ops.stale_kv_attention(q, kf, vf, ks, vs, tok_start=16)
    assert ops.launch_counts() == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            ops.load_library()
    meta = [t.to("meta") for t in (q, kf, vf, ks, vs)]
    with pytest.raises(ValueError, match="no stale_kv_attention kernel"):
        ops.stale_kv_attention(*meta, tok_start=16)
