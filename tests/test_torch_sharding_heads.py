"""The head split and merge of the port's models on DTensors
(``layers.split_heads`` / ``layers.merge_heads``).

DTensor refuses a view that splits or merges a dim whose shards do not
divide the new dims (GSPMD reshards such a dim implicitly); the helpers
move such a shard first (to the head dim, the sequence dim or a replica),
and put the gradient right before the view's backward. On 4 gloo ranks of
a (1, 4) mesh, with 2 heads (uneven over 4), 4 (even) and 25, the
helpers' results gathered are bitwise the plain ``reshape``'s, forward and
backward, and ``attention_qkv`` on DTensors is the plain one's. On a (2, 4)
fake mesh a reduced xLSTM with 2 heads traces its train step with the
helpers and fails without them, with DTensor's own error."""
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import ranks  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
HEADS = (2, 4, 25)
HD = 4


def _inputs(H, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 8, H * HD, generator=g)
    return x, torch.randn(2, 8, H, HD, generator=g)


def _heads_rank():
    """Each rank: the helpers on DTensors placed so that the view would be
    uneven (the H * hd dim split over 'model'), gathered; and the plain
    reshapes' values and gradients."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.models import layers

    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    out = {}
    for H in HEADS:
        x, w = _inputs(H, H)
        # split: x [B, S, H*hd] split over 'model'; the upstream gradient w
        # split on the head dim (uneven but for H = 4)
        xd = distribute_tensor(x, mesh, [Shard(0), Shard(2)]).requires_grad_()
        wd = distribute_tensor(w, mesh, [Shard(0), Shard(2)])
        y = layers.split_heads(xd, (H, HD))
        (y * wd).sum().backward()
        xp = x.clone().requires_grad_()
        (xp.reshape(2, 8, H, HD) * w).sum().backward()
        out[f"split{H}"] = (y.full_tensor(), xd.grad.full_tensor(),
                            xp.reshape(2, 8, H, HD).detach(), xp.grad)
        # merge: [B, S, H, hd] split on the head dim; the gradient split on
        # the merged dim
        md = distribute_tensor(w, mesh, [Shard(0), Shard(2)]).requires_grad_()
        gd = distribute_tensor(x, mesh, [Shard(0), Shard(2)])
        z = layers.merge_heads(md)
        (z * gd).sum().backward()
        mp = w.clone().requires_grad_()
        (mp.reshape(2, 8, -1) * x).sum().backward()
        out[f"merge{H}"] = (z.full_tensor(), md.grad.full_tensor(),
                            mp.reshape(2, 8, -1).detach(), mp.grad)
    return out


def _qkv_rank():
    """Each rank: ``attention_qkv`` on DTensors (x batch-split over
    'model', the projections' head columns split over it) and on the plain
    tensors, gathered."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.models import layers

    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    out = {}
    for H in HEADS:
        cfg = get_config("yi-9b").reduced().replace(
            n_heads=H, n_kv_heads=1, head_dim=HD, d_model=16,
            param_dtype="float32", dtype="float32")
        p = layers.init_attention(torch.Generator().manual_seed(H), cfg)
        x = torch.randn(4, 8, 16, generator=torch.Generator().manual_seed(H + 1))
        pos = torch.arange(8)[None, :]
        pd = {k: distribute_tensor(v, mesh, [Replicate(), Shard(1)])
              for k, v in p.items()}
        xd = distribute_tensor(x, mesh, [Replicate(), Shard(0)])
        with implicit_replication():
            got = [t.full_tensor() for t in layers.attention_qkv(pd, xd, cfg, pos)]
        out[H] = (got, list(layers.attention_qkv(p, x, cfg, pos)))
    return out


def _rank(ctx):
    return {"heads": _heads_rank(), "qkv": _qkv_rank()}


@pytest.fixture(scope="module")
def runs():
    return ranks.spawn(_rank, 4, device_type="cpu", timeout=300)


@pytest.mark.parametrize("H", HEADS)
@pytest.mark.parametrize("op", ["split", "merge"])
def test_helpers_are_the_plain_reshape(runs, op, H):
    for out in runs:
        value, grad, want, want_grad = out["heads"][f"{op}{H}"]
        assert torch.equal(value, want)
        assert torch.equal(grad, want_grad)


@pytest.mark.parametrize("H", HEADS)
def test_attention_qkv_on_dtensors(runs, H):
    for out in runs:
        got, want = out["qkv"][H]
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert torch.equal(g, w)


_TRACE = """
import sys, torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import layers
torch.set_num_threads(1)
dryrun.start_fake_world(8)
mesh = init_device_mesh("cuda", (2, 4), mesh_dim_names=("data", "model"))
cfg = shapes._dryrun_cfg("xlstm-125m").reduced().replace(n_heads=2)
if sys.argv[1] == "without":
    layers._even_for_view = lambda x, *a: x
try:
    t = dryrun.trace_step("xlstm-125m", ShapeSpec("tiny", "train", 32, 8), mesh, cfg)
    print("TRACED", t.flops)
except RuntimeError as e:
    print("REFUSED", str(e).splitlines()[0])
    print("RAISED BY DTENSOR", dryrun.raised_in_dtensor(e))
"""


@pytest.mark.parametrize("helpers", ["with", "without"])
def test_two_heads_trace_only_with_the_helpers(helpers):
    """2 heads over a 'model' dim of 4: the mLSTM's q split of [B, S, 2 *
    256] split over 'model' traces with the helpers; without them DTensor
    refuses the view (in torch 2.11's words, it will not split the sharded
    dimension), and the dry-run reads the error as DTensor's own."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_TRACE), helpers],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    if helpers == "with":
        assert "TRACED" in r.stdout, r.stdout[-2000:]
    else:
        assert ("REFUSED Cannot unflatten unevenly sharded tensor" in r.stdout
                or "Attempted to split the sharded dimension" in r.stdout), \
            r.stdout[-2000:]
        assert "RAISED BY DTENSOR True" in r.stdout, r.stdout[-2000:]
