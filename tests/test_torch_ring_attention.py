"""The port's ring attention (``surya_tpu_torch/parallel/ring_attention.py``)
and the ring shift and gradient rules under it (``core/mesh.py``), on two
gloo ranks of the CPU (one spawn, ``torch_dist_worker.py``) and in one
process (an axis of size 1 runs the same loop), against JAX's unsharded
``full_attention_reference`` on the same seeded inputs; and FACT with a
``cp_mesh`` against JAX's plain FACT (JAX's own test of it lives in its
``tests/test_ring_attention.py`` too).

Tolerances as JAX's ``tests/test_ring_attention.py``: f32 outputs 2e-5,
gradients 1e-4, bf16 5e-2. T = 9 does not divide the axis (the pad path).
Dropout: the block masks (:func:`block_keep` of the call's one draw) put
together into the whole (T, T) mask, and the output held to attention
written out with that mask on the normalised weights and an undropped
denominator (flax's semantics).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_dist_worker as W
from surya_tpu.parallel.ring_attention import (
    full_attention_reference as jax_full,
)
from surya_tpu_torch.core.mesh import single_device_mesh
from surya_tpu_torch.parallel.ring_attention import (
    NEG,
    block_keep,
    dropout_seed,
    full_attention_reference,
    shard_qkv,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401

QKV = (2, 9, 4, 8)
CASES = {"plain": {}, "divisible": {"shape": {"qkv": (2, 8, 4, 8)}},
         "causal": {"causal": True}, "padding_mask": {"pad_keys": 3},
         "bias": {"bias": True}, "grad": {"grad": True},
         "bf16": {"bf16": True},
         "dropout": {"dropout": 0.3, "seed": 4},
         "dropout_per_head": {"dropout": 0.3, "seed": 5,
                              "broadcast": False}}
SPEC = {"qkv": QKV, "cases": CASES, "seed": 0}


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """Every case on two gloo ranks (and the mesh rules, and FACT over a
    ``cp_mesh`` of 'seq' 2), and in one process; JAX's plain FACT (T 4: 9
    tokens, padded to 10 over two ranks; eval mode at dropout 0.1)."""
    from torch_fact_reference import FACT, jax_fact

    tmp = tmp_path_factory.mktemp("ring")
    kw = dict(FACT, seq_len=4, num_layers=2, dropout=0.1)
    fact = jax_fact(kw, {"batch": 2, "seq_len": 4, "seed": 6},
                    tmp / "fact.pt", train=False)
    sp2, rules, fact_sp2 = W.run([
        (W.ring_cases, {**SPEC, "world": 2}), (W.mesh_rules, {}),
        (W.fact_form, {**fact["spec"], "form": "sp", "mesh": {"seq": 2}})],
        2, tmp / "gloo")
    return {"sp2": sp2, "sp1": W.ring_cases(SPEC), "rules": rules,
            "fact": fact, "fact_sp2": fact_sp2}


def _jax_reference(case):
    """JAX's unsharded attention of a case (f32 unless bf16)."""
    q, k, v = W.qkv_of({**SPEC, **case.get("shape", {})})
    t = q.shape[1]
    dt = jnp.bfloat16 if case.get("bf16") else jnp.float32
    q, k, v = (jnp.asarray(a, dt) for a in (q, k, v))
    kw = {}
    if case.get("causal"):
        kw["mask"] = jnp.tril(jnp.ones((t, t), bool))
    if case.get("pad_keys"):
        kw["mask"] = (jnp.arange(t) < t - case["pad_keys"])[None, None,
                                                               None, :]
    if case.get("bias"):
        kw["bias"] = jnp.asarray(np.random.default_rng(7).normal(
            size=(1, q.shape[2], t, t)).astype(np.float32))
    return q, k, v, kw


def _dropped_attention(case, n):
    """Attention written out with the block masks of an ``n``-rank ring put
    together: dropout on the normalised weights, undropped denominator."""
    q, k, v = (torch.from_numpy(a) for a in W.qkv_of(SPEC))
    b, t, h, d = q.shape
    tp = t + (-t) % n
    blk = tp // n
    seed = dropout_seed(torch.Generator().manual_seed(case["seed"]))
    lead = (1, 1) if case.get("broadcast", True) else (b, h)
    keep = torch.cat([torch.cat([block_keep(seed, r, c, lead + (blk, blk),
                                            case["dropout"], "cpu")
                                 for c in range(n)], -1)
                      for r in range(n)], -2)[..., :t, :t]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    p = torch.softmax(s, -1)
    p = torch.where(keep, p / (1 - case["dropout"]), torch.zeros_like(p))
    return torch.einsum("bhqk,bkhd->bhqd", p, v).transpose(1, 2), keep


@pytest.mark.parametrize("world", ["sp2", "sp1"])
@pytest.mark.parametrize("name", [n for n in CASES
                                  if not n.startswith("dropout")])
def test_ring_matches_jax_full_attention(ring, world, name):
    case = CASES[name]
    q, k, v, kw = _jax_reference(case)
    want = np.asarray(jax_full(q, k, v, **kw), np.float32)
    tol = 5e-2 if case.get("bf16") else 2e-5
    for rank in ring[world] if world == "sp2" else [ring[world]]:
        np.testing.assert_allclose(rank[name]["out"].numpy(), want,
                                   rtol=tol, atol=tol)


def test_ring_gradients_match_jax(ring):
    """∂ sum(out²) / ∂(q, k, v): the slices' cotangents summed over 'seq'
    (rule 1), the gathered output's taken once (rule 2)."""
    import jax

    q, k, v, _ = _jax_reference(CASES["grad"])
    want = jax.grad(lambda a, b, c: jnp.sum(jax_full(a, b, c) ** 2),
                    argnums=(0, 1, 2))(q, k, v)
    for rank in [*ring["sp2"], ring["sp1"]]:
        for got, w in zip(rank["grad"]["grads"], want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["dropout", "dropout_per_head"])
def test_ring_dropout_is_the_assembled_block_mask(ring, name):
    """Each (row block, column block) mask is a function of the one draw
    and the two blocks: the ranks agree, and the output is attention with
    the assembled mask applied to the normalised weights (the denominator
    undropped), as flax drops; the ring of one draws its one block."""
    case = CASES[name]
    for world, ranks, n in (("sp2", ring["sp2"], 2),
                            ("sp1", [ring["sp1"]], 1)):
        want, keep = _dropped_attention(case, n)
        assert 0.5 < float(keep.float().mean()) < 0.9
        for rank in ranks:
            np.testing.assert_allclose(rank[name]["out"].numpy(),
                                       want.numpy(), rtol=2e-5, atol=2e-5,
                                       err_msg=world)
    assert not torch.allclose(ring["sp2"][0][name]["out"],
                              ring["sp2"][0]["plain"]["out"])


def test_ring_moves_one_kv_block_per_step(ring):
    """n − 1 shifts of the stacked (2, B, T/n, H, D) K/V block: at sp2 one
    block of 2·2·5·4·8 f32 (T 9 padded to 10); none on one rank."""
    for rank in ring["sp2"]:
        assert rank["plain"]["ppermute_bytes"] == 2 * 2 * 5 * 4 * 8 * 4
    assert ring["sp1"]["plain"]["ppermute_bytes"] == 0


@pytest.mark.parametrize("name", ["ppermute", "ppermute_back", "split",
                                  "split_whole", "gather", "combine_sum"])
def test_mesh_shift_and_gradient_rules(ring, name):
    """``ppermute`` sends up the ring and its backward down; ``split``
    (rule 1) sums its cotangent over the ranks; ``gather`` and
    ``combine_sum`` (rule 2) hand each rank its own part, unsummed."""
    ranks = ring["rules"]
    n = len(ranks)
    for me, r in enumerate(x[name] for x in ranks):
        up, down = (me + 1) % n, (me - 1) % n
        x, c = [x[name]["x"] for x in ranks], [x[name]["c"] for x in ranks]
        if name == "ppermute":
            want_y, want_g = x[down], c[up]
        elif name == "ppermute_back":
            want_y, want_g = x[up], c[down]
        elif name == "split":
            want_y, want_g = x[me][2 * me:2 * me + 2], torch.cat(c)
        elif name == "split_whole":
            want_y, want_g = x[me], sum(c)
        elif name == "gather":
            want_y, want_g = torch.cat(x), c[me][2 * me:2 * me + 2]
        else:
            want_y, want_g = sum(x), c[me]
        torch.testing.assert_close(r["y"], want_y, rtol=0, atol=0)
        torch.testing.assert_close(r["grad"], want_g, rtol=0, atol=0)


def test_fact_with_cp_mesh_matches_jax(ring):
    """``FactModel(cp_mesh=)`` runs ring attention in both fusion layers
    (eval: rate 0) and holds to JAX's plain FACT: logits 1e-5 and every
    gradient of the cross-entropy at rtol 1e-4 / atol 1e-5, the same on
    both ranks; K/V crossed the ring."""
    from torch_fact_reference import assert_grads

    ref = ring["fact"]
    for rank in ring["fact_sp2"]:
        np.testing.assert_allclose(rank["logits"].numpy(), ref["logits"],
                                   rtol=0, atol=1e-5)
        assert_grads(rank["grads"], ref["grads"], rtol=1e-4, atol=1e-5)
        assert rank["bytes"]["ppermute"] > 0


def test_single_device_pieces():
    """``shard_qkv`` on one device pads T to the axis (no-op at 1) and
    keeps the tensor; the port's ``full_attention_reference`` is JAX's;
    a masked key gets NEG, not −inf."""
    q, k, v = W.qkv_of(SPEC)
    mesh = single_device_mesh("cpu")
    x = torch.from_numpy(q)
    assert torch.equal(shard_qkv(mesh, x), x)
    mask = np.tril(np.ones((9, 9), bool))
    got = full_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                   mask=torch.from_numpy(mask))
    want = jax_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert NEG == -1e9
