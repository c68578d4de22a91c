"""The port's GPipe schedule (``surya_tpu_torch/parallel/pipeline.py``) and
``fact_apply_pipelined`` against JAX's unsharded FACT (the model of
``__graft_entry__.dryrun_multichip``: 4 fusion layers of width 32, one ViT
block, 32 px, batch 8; ``torch_fact_reference.py``) on gloo ranks of the
CPU, in one spawn of two: pp2 (two layers a stage) at 4 and 8
microbatches, and the pipelined path over dp2 (each rank its rows of each
microbatch). pp2×dp2 itself runs at world 8 in the slow
``tests/test_torch_parallel.py::test_fact_parallel_forms_at_world_size_8_match_jax``
(pp4×dp2 and pp2×tp2×dp2), which a second spawn of four would add to
tier-1's time.

Tolerances as JAX's ``tests/test_pipeline.py``: logits 1e-5, gradients
rtol 1e-4 / atol 1e-5 (every parameter's, the embed's reaching stage 0
only and summed over 'pipe', the layers' gathered from their stages).
Train mode with dropout 0.1, at pp2 and over dp2, is held to the
schedule written out as a plain loop on the global batch (one draw from
the caller's generator, then ``layer(act, fold_in(seed, i, j))`` for
each microbatch j and global layer i), not to the plain model's draws.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_dist_worker as W
from surya_tpu_torch.core.mesh import Mesh
from surya_tpu_torch.core.prng import fold_in
from surya_tpu_torch.models.temporal.fact import (
    FactModel,
    fact_apply_pipelined,
)
from surya_tpu_torch.parallel.pipeline import pipeline_apply, stage_range
from torch_fact_reference import FACT, assert_grads, jax_fact, port_model
from torch_port_fixtures import one_torch_thread  # noqa: F401

BATCH = {"batch": 8, "seed": 2}
TRAIN = {"model": port_model(dict(FACT, dropout=0.1)), "train": 5}


def written_out_train(spec: dict) -> dict:
    """The pipelined train-mode forward and backward as a plain loop on
    one process: the seed drawn from the caller's generator before the
    embed, as ``fact_apply_pipelined`` draws it, then for each microbatch
    j of the global batch and each global layer i,
    ``act = layer(act, fold_in(seed, i, j))``."""
    model = FactModel(dtype=torch.float32, **spec["model"])
    model.load_state_dict(torch.load(spec["weights"]), strict=True)
    model.train()
    gen = torch.Generator().manual_seed(spec["train"])
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    images, feats, labels = (torch.from_numpy(a)
                             for a in W.fact_inputs(spec))
    outs = []
    for j, act in enumerate(model.embed(images, feats, gen).chunk(
            spec["microbatches"])):
        for i in range(model.num_layers):
            act = getattr(model, f"fusion{i}")(act, fold_in(seed, i, j))
        outs.append(act)
    logits = model.head(torch.cat(outs))
    F.cross_entropy(logits, labels).backward()
    return {"logits": logits.detach(),
            "grads": {n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None}}


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    ref = jax_fact(FACT, BATCH, tmp / "fact.pt")
    spec = {**ref["spec"], "form": "pp"}
    jobs = {"m4": {**spec, "mesh": {"pipe": 2}, "microbatches": 4},
            "m8": {**spec, "mesh": {"pipe": 2}, "microbatches": 8},
            "train": {**spec, "mesh": {"pipe": 2}, "microbatches": 4,
                      **TRAIN},
            "dp2": {**spec, "mesh": {"pipe": 1, "data": 2},
                    "microbatches": 4},
            "dp2_train": {**spec, "mesh": {"pipe": 1, "data": 2},
                          "microbatches": 4, **TRAIN}}
    names = list(jobs)
    runs = dict(zip(names, W.run([(W.fact_form, jobs[k]) for k in names], 2,
                                 tmp / "gloo")))
    return ref, runs, runs["dp2"], written_out_train(jobs["train"])


@pytest.mark.parametrize("job", ["m4", "m8"])
def test_pipelined_fact_matches_jax(pipe, job):
    """Forward and every gradient of the cross-entropy at pp2, M 4 and 8,
    on both stages (the logits and the embed's and head's gradients are
    replicated over 'pipe')."""
    ref, pp2, _, _ = pipe
    for rank in pp2[job]:
        np.testing.assert_allclose(rank["logits"].numpy(), ref["logits"],
                                   rtol=1e-5, atol=1e-5)
        assert rank["loss"] == pytest.approx(ref["loss"], abs=1e-6)
        assert_grads(rank["grads"], ref["grads"], rtol=1e-4, atol=1e-5)


def test_pipelined_fact_over_dp2_matches_jax(pipe):
    """``batch_spec="data"``: each rank's logits are its rows of each
    microbatch, the data-averaged gradients JAX's."""
    ref, _, ppdp, _ = pipe
    for rank in ppdp:
        want = np.concatenate([ref["logits"][a:b] for a, b in rank["rows"]])
        np.testing.assert_allclose(rank["logits"].numpy(), want,
                                   rtol=1e-5, atol=1e-5)
        assert rank["loss"] == pytest.approx(ref["loss"], abs=1e-6)
        assert_grads(rank["grads"], ref["grads"], rtol=1e-4, atol=1e-5)


def test_pipelined_train_mode_is_the_sequential_run(pipe):
    """Dropout 0.1: each (global layer, microbatch) draws from its own
    generator folded from one draw, so the two stages give the written-out
    loop's logits and gradients; the draws are not the plain model's, and
    a mask reused over microbatches or layers would differ from the
    loop."""
    ref, pp2, _, sequential = pipe
    for rank in pp2["train"]:
        np.testing.assert_allclose(rank["logits"].numpy(),
                                   sequential["logits"].numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert_grads(rank["grads"], sequential["grads"], rtol=1e-4,
                     atol=1e-5)
    assert not np.allclose(sequential["logits"].numpy(), ref["logits"],
                           atol=1e-3)


def test_pipelined_train_mode_over_dp2_is_the_written_out_loop(pipe):
    """Dropout 0.1 with the batch over 'data': each rank's masks are its
    rows of the global microbatch's (``micro_rows``), so its logits are its
    rows of the loop's on the global batch and the data-averaged gradients
    the loop's."""
    _, runs, _, sequential = pipe
    for rank in runs["dp2_train"]:
        want = torch.cat([sequential["logits"][a:b] for a, b in rank["rows"]])
        np.testing.assert_allclose(rank["logits"].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert_grads(rank["grads"], sequential["grads"], rtol=1e-4,
                     atol=1e-5)


def test_each_stage_holds_its_layers_and_the_gathered_state_loads(pipe):
    """A stage stores only its two layers; the stages' state gathered is
    the single-device ``state_dict`` (strict load into a plain FACT), and
    the activations crossed the ring (M + S − 2 = 4 shifts of a microbatch
    of 2×5×32 f32 each way at M 4)."""
    ref, pp2, _, _ = pipe
    plain = FactModel(dtype=torch.float32, **port_model(FACT))
    plain.load_state_dict(pp2["m4"][0]["state"], strict=True)
    full = torch.load(ref["spec"]["weights"])
    for rank in pp2["m4"]:
        assert rank["bytes"]["ppermute"] == 2 * 4 * (2 * 5 * 32 * 4)
        for k, v in rank["state"].items():
            assert torch.equal(v, full[k]), k


def test_validation_errors():
    """JAX's errors: a batch the microbatches do not divide, layers the
    stages do not divide, MoE layers, train mode with dropout and no
    generator; ring attention does not compose with the pipeline; a
    pipelined layer keeps its input's shape and dtype."""
    model = FactModel(dtype=torch.float32, **port_model(FACT))
    images, feats, _ = (torch.from_numpy(a) for a in W.fact_inputs(
        {"batch": 6, "seq_len": 2, "size": 32, "classes": 8}))
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        fact_apply_pipelined(model, images, feats, None, num_microbatches=4)
    three = Mesh({"pipe": 3}, {"pipe": 0}, {"pipe": None})
    with pytest.raises(ValueError, match="4 layers not divisible by 3"):
        stage_range(4, three)
    with pytest.raises(ValueError, match="dropout generator"):
        fact_apply_pipelined(FactModel(**TRAIN["model"]).train(), images,
                             feats, None, num_microbatches=2)
    with pytest.raises(NotImplementedError, match="MoE"):
        fact_apply_pipelined(FactModel(**port_model(dict(
            FACT, moe_experts=2))), images, feats, None)
    seq2 = Mesh({"seq": 2}, {"seq": 0}, {"seq": None})
    with pytest.raises(ValueError, match="not with the pipelined"):
        fact_apply_pipelined(FactModel(cp_mesh=seq2, **port_model(FACT)),
                             images, feats, None)
    with pytest.raises(ValueError, match="keep its input's shape"):
        pipeline_apply(lambda a, j: a[:, :1], [], torch.zeros(4, 3), None,
                       num_microbatches=2)


def test_one_stage_is_the_plain_forward():
    """Without a mesh the schedule runs the layers microbatch by microbatch:
    the plain model's eval logits, with and without gradients."""
    model = FactModel(dtype=torch.float32, **port_model(FACT)).eval()
    model.reset_parameters(torch.Generator().manual_seed(0))
    images, feats, _ = (torch.from_numpy(a) for a in W.fact_inputs(
        {"batch": 4, "seq_len": 2, "size": 32, "classes": 8}))
    want = model(images, feats)
    got = fact_apply_pipelined(model, images, feats, None,
                               num_microbatches=2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    with torch.no_grad():
        torch.testing.assert_close(fact_apply_pipelined(
            model, images, feats, None, num_microbatches=4), want.detach(),
            rtol=0, atol=1e-6)
