"""LM training on the port against the JAX package on the CPU: the loss of
each of the ten assigned LMs (``reduced()`` in fp32; the xLSTM at 4 layers so
that its sLSTM block is in the graph) within 1e-5 relative of the
reference's ``Model.loss``, every gradient leaf within 1e-4 norm-relative
of ``jax.grad``'s (the MoE's router and load-balance loss through the
port's index dispatch against the reference's one-hot contraction; K6 and
K7 through their autograd Functions), the Functions' gradients on ragged
shapes equal to autograd of the plain versions, ``launch.train.train``
for 10 steps from the reference's weights on the same token stream
against the reference's ``train`` (losses within 1e-4), and
``TokenStream`` ``==`` the reference's for each seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import TokenStream as JTokenStream  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.api import build_model as jax_build_model  # noqa: E402
from repro_torch import bridge, tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.configs import LANGUAGE, get_config  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

torch.set_num_threads(1)
LOSS_RTOL = 1e-5
GRAD_BAR = 1e-4
NORM_LEAVES = ("ln", "ln1", "ln2", "lnx", "ln_f", "enc_ln_f", "dec_ln_f",
               "fuse_a", "fuse_m")


def _cfgs(arch):
    cfgs = [get(arch).reduced().replace(dtype="float32", param_dtype="float32")
            for get in (jax_get_config, get_config)]
    if arch == "xlstm-125m":          # layer 3 is the sLSTM block
        cfgs = [c.replace(n_layers=4) for c in cfgs]
    return cfgs


def _perturbed(tree, rng):
    """numpy leaves with the zero-initialized norm scales drawn from a
    normal of std 0.3."""
    if isinstance(tree, list):
        return [_perturbed(t, rng) for t in tree]
    return {k: (_perturbed(v, rng) if isinstance(v, (dict, list)) else
                (0.3 * rng.standard_normal(v.shape)).astype(v.dtype)
                if k in NORM_LEAVES else v)
            for k, v in tree.items()}


def _batch(cfg, B=2, S=12, seed=0):
    """numpy batch of the family: tokens and labels (+ stub vision
    embeddings), or an enc-dec's source frames and target tokens."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    out = {"tokens": tokens, "labels": tokens}
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        src = rng.standard_normal((B, 2 * S, cfg.d_model)).astype(np.float32)
        tgt = rng.integers(0, cfg.vocab, (B, 16))
        out = {"src_embeds": src, "tgt_tokens": tgt, "labels": tgt}
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
            for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(got, want):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    scale = np.linalg.norm(want)
    return np.linalg.norm(got - want) / (scale if scale else 1.0)


@pytest.mark.parametrize("arch", LANGUAGE)
def test_loss_and_gradients_match_jax_grad(arch):
    jcfg, tcfg = _cfgs(arch)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    leaves = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0)))
    leaves = _perturbed(leaves, np.random.default_rng(1))
    batch = _batch(jcfg, seed=2)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jax.tree_util.tree_map(jnp.asarray, leaves), _jax_batch(batch))
    params = tree_lib.tree_map(lambda t: t.requires_grad_(),
                               bridge.params_from_jax(leaves, device="cpu"))
    loss = tmodel.loss(params, _torch_batch(batch))
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    flat = tree_lib.leaves(params)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    jflat = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(jflat) == len(flat)
    errs = {jax.tree_util.keystr(path): _rel(torch.zeros_like(t) if g is None else g, w)
            for (path, w), t, g in zip(jflat, flat, grads)}
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_BAR, (worst, errs[worst])
    assert all(g is not None for g in grads)


def test_k6_function_gradients_equal_the_plain_versions():
    """``ops.flash_attention`` under autograd on ragged shapes (causal + window +
    prefix at S = T = 13 with GQA 4/2, and non-causal 7 queries over 11
    keys): its output and the gradients of q, K and V equal autograd of
    ``ref.flash_attention_ref``; with no operand requiring grad it runs
    outside the Function."""
    gen = torch.Generator().manual_seed(3)
    for (S, T), mask in [((13, 13), dict(causal=True, window=5, prefix_len=2)),
                         ((7, 11), dict(causal=False))]:
        leaves = [torch.randn(2, S, 4, 64, generator=gen),
                  torch.randn(2, T, 2, 64, generator=gen),
                  torch.randn(2, T, 2, 64, generator=gen)]
        w = torch.randn(2, S, 4, 64, generator=gen)
        outs, grads = [], []
        for fn in (ops.flash_attention, ref.flash_attention_ref):
            ins = [t.clone().requires_grad_() for t in leaves]
            out = fn(*ins, **mask)
            outs.append(out)
            grads.append(torch.autograd.grad((out * w).sum(), ins))
        assert outs[0].grad_fn is not None and "FlashAttention" in type(
            outs[0].grad_fn).__name__
        assert torch.equal(outs[0], outs[1])
        for g, want in zip(*grads):
            assert torch.equal(g, want)
        assert ops.flash_attention(*leaves, **mask).grad_fn is None


@pytest.mark.parametrize("wanted", ["y", "h", "both"])
def test_k7_function_gradients_equal_the_plain_versions(wanted):
    """``ops.ssm_scan`` under autograd with ``final_state`` on a ragged shape (S 13,
    Di 24, N 16, a nonzero h0 that requires grad): the gradients of every
    operand, h0 included, equal autograd of ``ref.ssm_scan_ref`` when the
    loss reads y only, the final state only, or both."""
    gen = torch.Generator().manual_seed(4)
    B, S, Di, N = 2, 13, 24, 16
    leaves = [torch.randn(B, S, Di, generator=gen),
              torch.nn.functional.softplus(torch.randn(B, S, Di, generator=gen) - 1),
              torch.randn(B, S, N, generator=gen), torch.randn(B, S, N, generator=gen),
              -torch.rand(Di, N, generator=gen) - 0.1, torch.rand(Di, generator=gen),
              torch.randn(B, Di, N, generator=gen)]
    wy, wh = torch.randn(B, S, Di, generator=gen), torch.randn(B, Di, N, generator=gen)
    grads = []
    for autograd in (True, False):
        ins = [t.clone().requires_grad_() for t in leaves]
        if autograd:
            y, h = ops.ssm_scan(*ins[:6], h0=ins[6], final_state=True)
        else:
            y, h = ref.ssm_scan_ref(*ins)
        loss = {"y": (y * wy).sum(), "h": (h * wh).sum(),
                "both": (y * wy).sum() + (h * wh).sum()}[wanted]
        grads.append(torch.autograd.grad(loss, ins, allow_unused=True))
    for g, want in zip(*grads):
        assert (g is None and want is None) or torch.equal(g, want)
    y = ops.ssm_scan(*[t.requires_grad_() for t in leaves[:6]])
    assert y.shape == (B, S, Di) and y.grad_fn is not None


def test_train_driver_matches_reference(tmp_path, capsys):
    """``train`` (the reference's defaults: gemma-2b reduced, batch 4, seq
    64, lr 1e-3; 10 steps here) from the reference's weights on the same
    token stream: each step's loss within 1e-4 of the reference's ``train``;
    the loss falls; the checkpoint (params and optimizer state) restores."""
    jparams, jlosses = jtrain.train("gemma-2b", steps=10)
    jcfg = jax_get_config("gemma-2b").reduced()
    init = jax.tree_util.tree_map(np.asarray, jax_build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    params, losses = ttrain.train("gemma-2b", steps=10, device="cpu",
                                  params=bridge.params_from_jax(init, "cpu"),
                                  ckpt_dir=str(tmp_path))
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-4)
    assert losses[-1] < losses[0]
    like = {"params": params, "opt": {"mu": params, "nu": params,
                                      "count": torch.zeros((), dtype=torch.int32)}}
    restored = restore_checkpoint(str(tmp_path), like)
    assert int(restored["opt"]["count"]) == 10
    for a, b in zip(tree_lib.leaves(restored["params"]), tree_lib.leaves(params)):
        assert torch.equal(a, b)
    assert "gemma-2b" in capsys.readouterr().out


def test_train_cli_and_families():
    """The CLI on the CPU (``--device cpu``), and one step of every family
    the driver draws its own batch for (the VLM's vision embeddings, the
    enc-dec's source frames, the hybrid's K6 and K7 Functions): finite."""
    params, losses = ttrain.main(["--device", "cpu", "--steps", "2", "--arch",
                                  "internvl2-76b", "--seq", "16"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    for arch in ("seamless-m4t-medium", "hymba-1.5b", "xlstm-125m"):
        _, losses = ttrain.train(arch, steps=1, batch=2, seq=32, device="cpu")
        assert np.isfinite(losses[0])


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_token_stream_equals_reference(seed):
    """The port's stream (no shard options: nothing in the port draws a
    shard) gives the reference's tokens at its default shard 0."""
    ours = TokenStream(50304, 40, 3, seed=seed)
    theirs = JTokenStream(50304, 40, 3, seed=seed)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for key in a:
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key])
    small = TokenStream(10, 8, 2, seed=seed)
    assert next(small)["tokens"].max() < 10
