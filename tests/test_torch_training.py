"""The diffusion training wing of the port against the JAX package, on the
CPU: the DDPM sampler and the eps-matching loss (``core/sampler.py``), K1
under autograd (``kernels/ops.py``: its gradients through ``dit.forward``
within 1e-4 of ``jax.grad`` of the reference's loss, relative to each
leaf's largest gradient, with the same bridged weights and the same (t,
eps); a planted dropped gradient fails that bar; an operand that requires
grad outside the Function is refused), ``SyntheticImages`` (bitwise),
AdamW (five steps within 1e-6) and the LR schedules (1e-7), the checkpoint
format (bitwise in both directions, the reference trainer's checkpoint
included), the bridge's lists and None leaves, and the CPU trainer (its
loss falls in 20 steps). Sizes are ``tiny-dit.reduced()`` in fp32."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import io as jckpt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import sampler as jsam  # noqa: E402
from repro.data import images as jimages  # noqa: E402
from repro.models.diffusion import dit as jdit  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import io as tckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.diffusion import DiTConfig  # noqa: E402
from repro_torch.core import sampler as tsam  # noqa: E402
from repro_torch.data import images as timages  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train_tiny_diffusion as trainer  # noqa: E402
from repro_torch.models.diffusion import dit as tdit  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_BAR = 1e-4
SAMPLER_BAR = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("tiny-dit").reduced()      # 2 blocks, 4 heads of 32
    jparams = jax.tree_util.tree_map(np.asarray, jdit.nondegenerate_params(
        jdit.init_params(jax.random.PRNGKey(0), jcfg)))
    tparams = bridge.params_from_jax(jparams, device="cpu")
    return jcfg, jparams, DiTConfig(**dataclasses.asdict(jcfg)), tparams


# ----------------------------------------------------------------------
# the sampler: DDPM and the loss
# ----------------------------------------------------------------------

def _eps_fns(T):
    """One eps model in both frameworks: smooth in x and in t."""
    jfn = lambda x, t: 0.3 * x * jnp.cos(t / T) + 0.1 * jnp.sin(x)
    tfn = lambda x, t: 0.3 * x * torch.cos(torch.tensor(t / T, dtype=torch.float32)) \
        + 0.1 * torch.sin(x)
    return jfn, tfn


@pytest.mark.parametrize("t", [1, 2, 7, 20])
def test_ddpm_step_matches_reference(t):
    sched_j, sched_t = jsam.linear_schedule(20), tsam.linear_schedule(20)
    rng = np.random.default_rng(t)
    x, eps, z = (rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
                 for _ in range(3))
    want = np.asarray(jsam.ddpm_step(sched_j, *map(jnp.asarray, (x, eps)), t,
                                     jnp.asarray(z)))
    got = tsam.ddpm_step(sched_t, *map(torch.from_numpy, (x, eps)), t,
                         torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=SAMPLER_BAR)
    if t == 1:                       # the last step adds no noise
        np.testing.assert_array_equal(got, tsam.ddpm_step(
            sched_t, *map(torch.from_numpy, (x, eps)), t,
            torch.zeros(x.shape)).numpy())


def test_ddpm_sample_matches_reference_with_its_noise():
    """T = 20 steps, the port fed the reference's own draws."""
    T = 20
    jfn, tfn = _eps_fns(T)
    x_T = np.random.default_rng(3).standard_normal((2, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jsam.ddpm_sample(jfn, jsam.linear_schedule(T),
                                       jnp.asarray(x_T), key))
    noise, rng = [], key
    for _ in range(T):
        rng, k = jax.random.split(rng)
        noise.append(torch.from_numpy(np.array(
            jax.random.normal(k, x_T.shape, jnp.float32))))
    got = tsam.ddpm_sample(tfn, tsam.linear_schedule(T), torch.from_numpy(x_T),
                           torch.Generator(), noise=noise).numpy()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=SAMPLER_BAR)
    # its own draws: deterministic in the generator's seed
    a, b = (tsam.ddpm_sample(tfn, tsam.linear_schedule(T),
                             torch.from_numpy(x_T),
                             torch.Generator().manual_seed(5)) for _ in range(2))
    assert torch.equal(a, b) and not torch.equal(a, torch.from_numpy(got))


def test_ddim_timesteps_takes_the_unused_warmup_offset():
    for T, M in ((1000, 16), (100, 8), (20, 5)):
        np.testing.assert_array_equal(
            tsam.ddim_timesteps(T, M, warmup_offset=3).numpy(),
            np.asarray(jsam.ddim_timesteps(T, M, warmup_offset=3)))


def _reference_draws(x0, key, T):
    """The reference's diffusion_loss draws, drawn as it draws them."""
    kt, ke = jax.random.split(key)
    t = jax.random.randint(kt, (x0.shape[0],), 1, T + 1)
    eps = jax.random.normal(ke, x0.shape, jnp.float32)
    return np.array(t), np.array(eps)


def test_diffusion_loss_draws_from_its_generator(model):
    _, _, tcfg, tparams = model
    sched = tsam.linear_schedule(100)
    x0 = torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    fn = lambda x, t: tdit.forward(tparams, tcfg, x, t, torch.tensor([1]))
    a, b = (tsam.diffusion_loss(fn, sched, x0, torch.Generator().manual_seed(9))
            for _ in range(2))
    assert torch.equal(a, b) and a.dim() == 0 and torch.isfinite(a)
    gen = torch.Generator().manual_seed(9)
    t = torch.randint(1, 101, (4,), generator=gen)
    eps = torch.randn(x0.shape, generator=gen)
    assert torch.equal(a, tsam.diffusion_loss_at(fn, sched, x0, t, eps))
    assert 1 <= int(t.min()) and int(t.max()) <= 100


# ----------------------------------------------------------------------
# K1 under autograd: the training gradients
# ----------------------------------------------------------------------

def _loss_grads(model, key=jax.random.PRNGKey(4)):
    jcfg, jparams, tcfg, tparams = model
    T = 1000
    x0 = np.random.default_rng(6).uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    cls = np.array([1, 5, 9, 14])

    def jloss(p):
        return jsam.diffusion_loss(
            lambda x, t: jdit.forward(p, jcfg, x, t, jnp.asarray(cls)),
            jsam.linear_schedule(T), jnp.asarray(x0), key)
    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(jparams)
    t, eps = _reference_draws(jnp.asarray(x0), key, T)
    p = tree_lib.tree_map(lambda a: a.detach().requires_grad_(), tparams)
    loss = tsam.diffusion_loss_at(
        lambda x, tt: tdit.forward(p, tcfg, x, tt, torch.from_numpy(cls)),
        tsam.linear_schedule(T), torch.from_numpy(x0), torch.from_numpy(t),
        torch.from_numpy(eps))
    grads = torch.autograd.grad(loss, tree_lib.leaves(p), allow_unused=True)
    return (float(jl), jax.tree_util.tree_leaves(jgrads), float(loss.detach()),
            grads, [k for k, _ in _named_leaves(tparams)])


def _named_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named_leaves(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tree[k]


def _worst_relative(grads, want):
    out = []
    for g, w in zip(grads, want):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        out.append(np.abs(g - w).max() / max(np.abs(w).max(), 1e-12))
    return out


def test_loss_gradients_through_k1_function_match_jax_grad(model, monkeypatch):
    """Every block's all-fresh read goes through the Function: its forward
    runs K1's plain version here, its backward recomputes that plain
    version (two calls a block)."""
    calls = []
    plain = ref.stale_kv_attention_ref
    monkeypatch.setattr(ref, "stale_kv_attention_ref",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    jl, want, tl, grads, names = _loss_grads(model)
    assert len(calls) == 2 * model[2].n_layers
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    worst = _worst_relative(grads, want)
    assert max(worst) < GRAD_BAR, dict(zip(names, worst))


def test_dropped_attention_gradient_fails_the_bar(model, monkeypatch):
    """What a K1 launch with no grad_fn would do on the card: the qkv
    projection's gradient through attention vanishes, and the bar sees it."""
    monkeypatch.setattr(ops, "stale_kv_attention_autograd",
                        lambda *a, tok_start: ops.stale_kv_attention(
                            *(t.detach() for t in a), tok_start=tok_start))
    _, want, _, grads, names = _loss_grads(model)
    worst = dict(zip(names, _worst_relative(grads, want)))
    assert worst["blocks.qkv"] > 0.5, worst


def test_function_gradients_equal_autograd_of_the_plain_version():
    rng = np.random.default_rng(8)
    arrs = [torch.from_numpy(rng.standard_normal((2, n, 4, 32)).astype(np.float32))
            for n in (24, 24, 24, 64, 64)]
    leaves = [a.clone().requires_grad_() for a in arrs]
    out = ops.stale_kv_attention_autograd(*leaves, tok_start=16)
    w = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad((out * w).sum(), leaves)
    leaves2 = [a.clone().requires_grad_() for a in arrs]
    want = torch.autograd.grad(
        (ref.stale_kv_attention_ref(*leaves2, 16) * w).sum(), leaves2)
    for g, h in zip(got, want):
        torch.testing.assert_close(g, h, rtol=0.0, atol=1e-6)
    assert out.grad_fn is not None


def test_untracked_gradient_is_refused():
    """The card's wrappers call this before a launch: an operand that
    requires grad with grad mode on raises; under no_grad (or inside the
    Function's forward) it passes."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops._refuse_untracked_grad("stale_kv_attention", (x.detach(), x))
    with torch.no_grad():
        ops._refuse_untracked_grad("stale_kv_attention", (x,))
    ops._refuse_untracked_grad("stale_kv_attention", (x.detach(),))


# ----------------------------------------------------------------------
# data, optimizer, schedules
# ----------------------------------------------------------------------

@pytest.mark.parametrize("size,channels,seed", [(32, 3, 0), (16, 4, 3)])
def test_synthetic_images_bitwise(size, channels, seed):
    want = jimages.SyntheticImages(size, channels, 16, seed).batches(5, seed + 2)
    got = timages.SyntheticImages(size, channels, 16, seed).batches(5, seed + 2)
    for _ in range(3):
        (wi, wc), (gi, gc) = next(want), next(got)
        assert gi.dtype == wi.dtype and gc.dtype == wc.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gc, wc)


def test_lr_schedules_match_reference():
    for step in range(0, 420, 7):
        assert abs(float(tsched.linear_warmup(step, 20))
                   - float(jsched.linear_warmup(step, 20))) <= 1e-7
        for total, warm, frac in ((400, 20, 0.1), (50, 0, 0.0), (7, 9, 0.3)):
            assert abs(float(tsched.cosine_schedule(step, total, warm, frac))
                       - float(jsched.cosine_schedule(step, total, warm, frac))
                       ) <= 1e-7


def test_adamw_five_steps_match_reference():
    """A tree of matrices, stacked blocks and vectors (decay on ndim >= 2
    only), gradients large enough for the global-norm clip to act on some
    steps, the cosine LR scale."""
    rng = np.random.default_rng(12)
    shapes = {"w": (6, 5), "b": (5,), "blocks": {"qkv": (2, 5, 15), "g": (2, 5)}}
    params = tree_lib.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes)
    cfg_kw = dict(lr=2e-3, weight_decay=1e-2, grad_clip=1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tree_lib.tree_map(torch.from_numpy, params)
    js, ts = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for step in range(5):
        g = tree_lib.tree_map(lambda s: (rng.standard_normal(s) * (3.0 if step % 2
                                         else 0.05)).astype(np.float32), shapes)
        jscale = jsched.cosine_schedule(js["count"], 5, warmup_steps=2)
        tscale = tsched.cosine_schedule(ts["count"], 5, warmup_steps=2)
        jp, js = jadamw.adamw_update(jp, jax.tree_util.tree_map(jnp.asarray, g),
                                     js, jadamw.AdamWConfig(**cfg_kw), jscale)
        tp, ts = tadamw.adamw_update(tp, tree_lib.tree_map(torch.from_numpy, g),
                                     ts, tadamw.AdamWConfig(**cfg_kw), tscale)
    assert int(ts["count"]) == int(js["count"]) == 5
    for tree_t, tree_j in ((tp, jp), (ts["mu"], js["mu"]), (ts["nu"], js["nu"])):
        for a, b in zip(tree_lib.leaves(tree_t), jax.tree_util.tree_leaves(tree_j)):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0.0,
                                       atol=1e-6)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal((4, 4)).astype(np.float32),
         "b": [rng.standard_normal(3).astype(np.float32), None]}
    for max_norm in (0.5, 100.0):
        jg, jn = jadamw.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, g), max_norm)
        tg, tn = tadamw.clip_by_global_norm(tree_lib.tree_map(torch.from_numpy, g),
                                            max_norm)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        for a, b in zip(tree_lib.leaves(tg), jax.tree_util.tree_leaves(jg)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------

def _ckpt_tree(rng):
    """Dicts, a list with a None (the UNet's last downsample), a tuple."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"params": {"w": f(3, 4), "down": [{"conv": f(3, 3, 2, 2),
                                               "downsample": f(2)},
                                              {"conv": f(3, 3, 2, 2),
                                               "downsample": None}]},
            "count": np.array(7, np.int32), "pair": (f(2), f(1))}


def test_checkpoints_restore_bitwise_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    tree = _ckpt_tree(rng)
    ttree = tree_lib.tree_map(torch.from_numpy, tree)
    # the port writes, the reference restores
    tckpt.save_checkpoint(str(tmp_path / "t"), 3, ttree)
    meta = json.load(open(tmp_path / "t" / "step_00000003" / "tree.json"))
    assert meta == {"treedef": str(jax.tree_util.tree_structure(tree)),
                    "n": 7, "step": 3}
    back = jckpt.restore_checkpoint(str(tmp_path / "t"), tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the reference writes, the port restores
    jckpt.save_checkpoint(str(tmp_path / "j"), 5, tree)
    assert tckpt.latest_step(str(tmp_path / "j")) == 5
    got = tckpt.restore_checkpoint(str(tmp_path / "j"), ttree)
    assert got["params"]["down"][1]["downsample"] is None
    assert isinstance(got["pair"], tuple)
    for a, b in zip(tree_lib.leaves(got), tree_lib.leaves(ttree)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore_checkpoint(str(tmp_path / "j"), {"w": ttree["params"]["w"]})


def test_bf16_checkpoint_leaves(tmp_path):
    """numpy has no bfloat16: the port writes bf16 widened to fp32 and
    restores it in like's dtype; the reference's bf16 (read back as 2-byte
    void) is widened the same way. Both bitwise."""
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    tckpt.save_checkpoint(str(tmp_path / "t"), 1, {"x": x})
    assert torch.equal(tckpt.restore_checkpoint(str(tmp_path / "t"), {"x": x})["x"], x)
    jckpt.save_checkpoint(str(tmp_path / "j"), 1,
                          {"x": jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)})
    got = tckpt.restore_checkpoint(str(tmp_path / "j"), {"x": x})["x"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, x)


def test_reference_trainer_checkpoint_restores_in_the_port(tmp_path):
    """The reference trainer's own checkpoint ({"params": tiny-dit}), a few
    steps of it, restored by both packages: bitwise the same leaves."""
    ckpt = tmp_path / "tiny_dit_ckpt"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "examples",
                                                     "train_tiny_diffusion.py"),
                        "--steps", "6", "--batch", "4", "--ckpt-dir", str(ckpt)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    cfg = get_config("tiny-dit")
    like = {"params": tdit.init_params(torch.Generator().manual_seed(0), cfg)}
    got = tckpt.restore_checkpoint(str(ckpt), like)
    jlike = {"params": jdit.init_params(jax.random.PRNGKey(0),
                                        jax_get_config("tiny-dit"))}
    want = jckpt.restore_checkpoint(str(ckpt), jlike)
    for a, b in zip(tree_lib.leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), b)
    # and the restored weights run the port's forward
    x = torch.zeros(1, cfg.latent_size, cfg.latent_size, cfg.channels)
    assert torch.isfinite(tdit.forward(got["params"], cfg, x, 500,
                                       torch.tensor([3]))).all()


# ----------------------------------------------------------------------
# the trainer
# ----------------------------------------------------------------------

def test_cpu_trainer_lowers_the_loss_and_checkpoints(tmp_path):
    """The entry point at 20 steps (batch 8 to keep the CPU run short): the
    loss falls (its own assertion), the checkpoint restores bitwise."""
    res = trainer.main(["--device", "cpu", "--steps", "20", "--batch", "8",
                        "--ckpt-dir", str(tmp_path)])
    assert len(res.losses) == 20 and res.losses[-1] < res.losses[0]
    assert int(res.opt_state["count"]) == 20
    got = tckpt.restore_checkpoint(str(tmp_path), {"params": res.params}, 20)
    for a, b in zip(tree_lib.leaves(got), tree_lib.leaves(res.params)):
        assert torch.equal(a, b)


def test_trainer_defaults_follow_the_reference():
    """The reference's flags and defaults, its AdamW decay and warm-up; the
    card unless --device cpu (no card here: it raises, never falls back)."""
    args = trainer.parser().parse_args([])
    assert (args.steps, args.batch, args.lr, args.seed, args.device) == \
        (400, 32, 2e-3, 0, "cuda")
    assert args.ckpt_dir.endswith(os.path.join("results", "tiny_dit_ckpt_torch"))
    src = open(os.path.join(REPO, "examples", "train_tiny_diffusion.py")).read()
    for text in ('"--steps", type=int, default=400',
                 '"--batch", type=int, default=32',
                 '"--lr", type=float, default=2e-3',
                 "weight_decay=1e-4", "warmup_steps=20"):
        assert text in src, text
    assert (trainer.WEIGHT_DECAY, trainer.WARMUP_STEPS) == (1e-4, 20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.main(["--steps", "1", "--ckpt-dir", "unused"])
