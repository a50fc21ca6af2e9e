"""The port's sequence parallelism (paddle_tpu_torch.parallel) against the
JAX package's, four ranks each.

The port runs in 4 gloo processes (``torch.multiprocessing.spawn``, a
``FileStore`` in ``tmp_path``, no TCP port), each holding its [B, H, T/4,
D] chunk; the JAX package runs the same numpy-seeded inputs as global
arrays through ``shard_map`` on the conftest's simulated CPU devices
(``build_mesh({"seq": 4})``, ``{"data": 2, "seq": 2}``).  Two spawns, each
running every case of its fixture once, so each takes a few seconds:

* the ring (flash body over the plain flat versions, and the einsum
  body), causal and not, with a key bias: outputs and the q, k, v and
  kbias gradients of sum(o * w); Ulysses (outputs and gradients, dropout
  masks that differ across ranks, indivisible heads rejected);
* the data 2 x seq 2 train step of ``_dryrun_seq`` (__graft_entry__.py):
  q = x w, causal ring attention over the seq group, the MSE against y,
  gradients all-reduced over data and seq, SGD at 0.1, three steps; and
  the mesh's axis groups.

The spawned function imports neither jax nor paddle_tpu; the parent
imports them lazily.  Tolerances are those of tests/test_seq_parallel.py:
rtol 2e-4 / atol 2e-5 forward, rtol 1e-3 / atol 1e-4 gradients (float32
on both sides, summed in other orders); train-step losses within 2e-3
(``_PARITY_TOL``) and w within rtol 1e-4.
"""
import os

import numpy as np
import pytest
import torch

WORLD = 4
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
RING_CASES = [(body, causal) for body in ("flash", "einsum")
              for causal in (False, True)]
# ring and Ulysses inputs: global [B, H, T, D], a kbias [B, T] and w
B, H, T, D = 2, 2, 32, 8
UH = 4                                  # Ulysses heads (divisible by 4)
# train step (_dryrun_seq at 4 devices: dp 2, sp 2)
DP, SP, STEPS = 2, 2, 3
TB, TH, TT, TD = 2 * DP, 2, 8 * SP, 8


def _ring_inputs():
    rng = np.random.RandomState(21)
    q, k, v, w = (rng.randn(B, H, T, D).astype(np.float32) for _ in range(4))
    kbias = rng.randn(B, T).astype(np.float32)
    kbias[0, 25:] = -1e4                  # a padded tail
    uq, uk, uv, uw = (rng.randn(B, UH, T, D).astype(np.float32)
                      for _ in range(4))
    return dict(q=q, k=k, v=v, w=w, kbias=kbias, uq=uq, uk=uk, uv=uv, uw=uw)


def _train_inputs():
    rng = np.random.RandomState(5)
    x = rng.randn(TB, TH, TT, TD).astype(np.float32)
    y = rng.randn(TB, TH, TT, TD).astype(np.float32)
    w0 = (rng.randn(TD, TD) * 0.1).astype(np.float32)
    return x, y, w0


# -- the spawned ranks (no jax, no paddle_tpu) -------------------------------

def _init(rank, store_path):
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)


def _chunk(a, rank, parts, axis=2):
    return torch.from_numpy(np.array_split(a, parts, axis=axis)[rank].copy())


def _ring_worker(rank, store_path, out_dir):
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import (build_mesh, ring_attention,
                                           ulysses_attention)

    _init(rank, store_path)
    mesh = build_mesh({"seq": WORLD}, device_type="cpu")
    d = _ring_inputs()
    res = {}
    for body, causal in RING_CASES:
        leaves = [_chunk(d[n], rank, WORLD).requires_grad_()
                  for n in ("q", "k", "v")]
        kb = _chunk(d["kbias"], rank, WORLD, axis=1).requires_grad_()
        o = ring_attention(*leaves, kbias=kb, mesh=mesh, axis="seq",
                           causal=causal, use_flash=body == "flash")
        grads = torch.autograd.grad(
            (o * _chunk(d["w"], rank, WORLD)).sum(), leaves + [kb])
        res[(body, causal)] = [t.detach().numpy() for t in (o, *grads)]
    leaves = [_chunk(d[n], rank, WORLD).requires_grad_()
              for n in ("uq", "uk", "uv")]
    o = ulysses_attention(*leaves, mesh=mesh, axis="seq")
    grads = torch.autograd.grad((o * _chunk(d["uw"], rank, WORLD)).sum(),
                                leaves)
    res["ulysses"] = [t.detach().numpy() for t in (o, *grads)]
    # dropout: identical inputs in every head, so after the seq->head
    # all-to-all each rank's one head differs only by its mask
    same = [torch.from_numpy(np.repeat(d[n][:, :1], UH, axis=1))
            for n in ("uq", "uk", "uv")]
    same = [_chunk(a.numpy(), rank, WORLD) for a in same]
    res["ulysses_dropout"] = ulysses_attention(
        *same, mesh=mesh, dropout_rate=0.5, rng=7).numpy()
    res["ulysses_no_dropout"] = ulysses_attention(*same, mesh=mesh).numpy()
    try:
        ulysses_attention(*(t[:, :3] for t in same), mesh=mesh)
        res["indivisible"] = "accepted"
    except ValueError as e:
        res["indivisible"] = str(e)
    torch.save(res, os.path.join(out_dir, f"ring{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _train_worker(rank, store_path, out_dir):
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import build_mesh, ring_attention

    _init(rank, store_path)
    res = {}
    try:
        build_mesh({"data": 3}, device_type="cpu")
    except ValueError as e:
        res["bad_mesh"] = str(e)
    mesh = build_mesh({"data": -1, "seq": SP}, device_type="cpu")
    res["mesh"] = (tuple(mesh.mesh.shape), mesh.mesh_dim_names,
                   dist.get_rank(mesh.get_group("seq")),
                   dist.get_rank(mesh.get_group("data")))
    d_idx, s_idx = divmod(rank, SP)       # mesh coordinates, row-major
    x, y, w0 = _train_inputs()
    x_l = _chunk(np.array_split(x, DP)[d_idx], s_idx, SP)
    y_l = _chunk(np.array_split(y, DP)[d_idx], s_idx, SP)
    total = float(y.size)
    for body in ("flash", "einsum"):
        w = torch.from_numpy(w0.copy())
        losses = []
        for _ in range(STEPS):
            w_leaf = w.clone().requires_grad_()
            q = torch.einsum("bhtd,de->bhte", x_l, w_leaf)
            o = ring_attention(q, x_l, x_l, mesh=mesh, axis="seq",
                               causal=True, use_flash=body == "flash")
            loss = ((o - y_l) ** 2).sum() / total
            (g,) = torch.autograd.grad(loss, [w_leaf])
            loss = loss.detach()
            for axis in ("data", "seq"):
                dist.all_reduce(loss, group=mesh.get_group(axis))
                dist.all_reduce(g, group=mesh.get_group(axis))
            losses.append(float(loss))
            w = w - 0.1 * g
        res[body] = (losses, w.numpy())
    torch.save(res, os.path.join(out_dir, f"train{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _spawn(worker, tmp_path, name):
    import torch.multiprocessing as mp

    out = tmp_path / name
    out.mkdir()
    mp.spawn(worker, args=(str(tmp_path / f"{name}.store"), str(out)),
             nprocs=WORLD, join=True)
    return [torch.load(out / f"{name}{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _gather(per_rank, key, i, axis=2):
    return np.concatenate([r[key][i] for r in per_rank], axis=axis)


# -- the JAX side (imported lazily: the ranks must not import it) ------------

@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    return _spawn(_ring_worker, tmp_path_factory.mktemp("ring"), "ring")


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    return _spawn(_train_worker, tmp_path_factory.mktemp("train"), "train")


def _jax_ring(body, causal):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas_ops import xla_attention
    from paddle_tpu.parallel import build_mesh
    from paddle_tpu.parallel.ring_attention import ring_attention

    d = _ring_inputs()
    mesh = build_mesh({"seq": WORLD})
    args = [jnp.asarray(d[n]) for n in ("q", "k", "v", "kbias")]
    w = jnp.asarray(d["w"])

    def ring(q, k, v, b):
        return ring_attention(q, k, v, kbias=b, mesh=mesh, axis="seq",
                              causal=causal, use_flash=body == "flash",
                              interpret=True)

    def plain(q, k, v, b):
        return xla_attention(q, k, v, bias=b[:, None, None, :], causal=causal)

    out = {}
    for name, fn in (("ring", ring), ("plain", plain)):
        o = fn(*args)
        g = jax.grad(lambda *a: jnp.sum(fn(*a) * w), argnums=(0, 1, 2, 3))(
            *args)
        out[name] = [np.asarray(t) for t in (o, *g)]
    return out


@pytest.mark.parametrize("body,causal", RING_CASES)
def test_ring_attention_matches_jax(ring_runs, body, causal):
    want = _jax_ring(body, causal)
    names = ("o", "dq", "dk", "dv", "dkbias")
    for i, name in enumerate(names):
        got = _gather(ring_runs, (body, causal), i,
                      axis=1 if name == "dkbias" else 2)
        tol = FWD_TOL if name == "o" else GRAD_TOL
        for ref in ("ring", "plain"):
            np.testing.assert_allclose(got, want[ref][i], err_msg=(name, ref),
                                       **tol)


def test_ulysses_matches_jax(ring_runs):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas_ops import xla_attention
    from paddle_tpu.parallel import build_mesh
    from paddle_tpu.parallel.ring_attention import ulysses_attention

    d = _ring_inputs()
    mesh = build_mesh({"seq": WORLD})
    args = [jnp.asarray(d[n]) for n in ("uq", "uk", "uv")]
    w = jnp.asarray(d["uw"])
    for fn in (lambda q, k, v: ulysses_attention(q, k, v, mesh=mesh),
               xla_attention):
        o = fn(*args)
        g = jax.grad(lambda *a: jnp.sum(fn(*a) * w), argnums=(0, 1, 2))(
            *args)
        for i, ref in enumerate((o, *g)):
            np.testing.assert_allclose(_gather(ring_runs, "ulysses", i),
                                       np.asarray(ref),
                                       **(FWD_TOL if i == 0 else GRAD_TOL))


def test_ulysses_dropout_decorrelated_across_ranks(ring_runs):
    """With identical heads, rank p owns head p after the seq->head
    all-to-all: masks shared across ranks would make the heads equal."""
    o = np.concatenate([r["ulysses_dropout"] for r in ring_runs], axis=2)
    o_nodrop = np.concatenate([r["ulysses_no_dropout"] for r in ring_runs],
                              axis=2)
    assert not np.allclose(o, o_nodrop), "dropout was not applied"
    for h in range(1, UH):
        assert not np.allclose(o[:, 0], o[:, h]), (
            f"ranks 0 and {h} drew identical dropout masks")


def test_ulysses_rejects_indivisible_heads(ring_runs):
    for r in ring_runs:
        assert "divisible" in r["indivisible"], r["indivisible"]


@pytest.mark.parametrize("body", ["flash", "einsum"])
def test_seq_parallel_train_step_matches_jax(train_runs, body):
    """_dryrun_seq's data x seq step: the port's ranks against JAX's
    shard_map'd step and its single-device reference."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.ops.pallas_ops import xla_attention
    from paddle_tpu.parallel import build_mesh
    from paddle_tpu.parallel.ring_attention import ring_attention

    mesh = build_mesh({"data": DP, "seq": SP})
    x, y, w0 = (jnp.asarray(a) for a in _train_inputs())
    total = float(np.prod(y.shape))

    def ref_step(w):
        def loss_fn(w):
            q = jnp.einsum("bhtd,de->bhte", x, w)
            o = xla_attention(q, x, x, causal=True)
            return jnp.sum((o - y) ** 2) / total

        l, g = jax.value_and_grad(loss_fn)(w)
        return l, w - 0.1 * g

    def shard_step(w, x_l, y_l):
        def loss_fn(w):
            q = jnp.einsum("bhtd,de->bhte", x_l, w)
            o = ring_attention(q, x_l, x_l, axis="seq", causal=True)
            return jnp.sum((o - y_l) ** 2) / total

        l, g = jax.value_and_grad(loss_fn)(w)
        return (lax.psum(l, ("data", "seq")),
                w - 0.1 * lax.psum(g, ("data", "seq")))

    mapped = jax.jit(jax.shard_map(
        shard_step, mesh=mesh,
        in_specs=(P(), P("data", None, "seq", None),
                  P("data", None, "seq", None)),
        out_specs=(P(), P()), check_vma=False))
    refs = {}
    for name, step in (("ref", lambda w: ref_step(w)),
                       ("shard", lambda w: mapped(w, x, y))):
        w, losses = w0, []
        for _ in range(STEPS):
            l, w = step(w)
            losses.append(float(l))
        refs[name] = (losses, np.asarray(w))
    for r in train_runs:
        losses, w = r[body]
        for name, (ref_losses, ref_w) in refs.items():
            assert np.max(np.abs(np.subtract(losses, ref_losses))) < 2e-3, (
                name, losses, ref_losses)
            np.testing.assert_allclose(w, ref_w, rtol=1e-4, atol=1e-6,
                                       err_msg=name)


def test_mesh_axes_and_groups(train_runs):
    for rank, r in enumerate(train_runs):
        shape, names, seq_rank, data_rank = r["mesh"]
        assert shape == (DP, SP) and names == ("data", "seq")
        assert (data_rank, seq_rank) == divmod(rank, SP)
        assert "needs 3 processes" in r["bad_mesh"], r["bad_mesh"]


def test_ring_dispatch_on_one_rank():
    """Without a process group the ring is the one-rank case.  On CPU
    tensors use_flash=None takes the flash body over equal chunks (the
    einsum ring's result) and the einsum ring over unequal ones, and the
    flash body refuses causal unequal chunks: its chunk-level causal
    dispatch needs them equal."""
    from paddle_tpu_torch.parallel import ring_attention

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, H, n, D, generator=g) for n in (T, T, T))
    kb = torch.randn(B, T, generator=g)
    for causal in (False, True):
        torch.testing.assert_close(
            ring_attention(q, k, v, kbias=kb, causal=causal),
            ring_attention(q, k, v, kbias=kb, causal=causal, use_flash=False),
            **FWD_TOL)
    k2, v2 = k.repeat(1, 1, 2, 1), v.repeat(1, 1, 2, 1)
    torch.testing.assert_close(
        ring_attention(q, k2, v2),
        ring_attention(q, k2, v2, use_flash=True), **FWD_TOL)
    with pytest.raises(ValueError, match="equal"):
        ring_attention(q, k2, v2, causal=True, use_flash=True)
