"""JAX's unsharded FACT as the reference of the port's parallel FACT tests
(ring attention, the pipeline, expert parallelism): the model of
``__graft_entry__.dryrun_multichip`` (embed 32, 4 heads, one ViT block of
2 heads, 32 px, T 2 so 5 tokens, f32, dropout 0, the ViT trained), seeded
numpy weights, and its logits, loss (cross-entropy plus the MoE's aux
term) and parameter gradients in the port's names."""

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

import torch_dist_worker as W
from surya_tpu.models.temporal.fact import FactModel as JaxFact
from surya_tpu_torch.models.from_jax import from_jax_variables
from test_torch_resnet import numpy_variables

FACT = dict(num_classes=8, seq_len=2, num_features=47, embed_dim=32,
            num_layers=4, num_heads=4, vit_depth=1, vit_heads=2,
            freeze_backbone=False, dropout=0.0)
FACT_MOE = dict(FACT, num_layers=2, moe_experts=4)
INPUTS = {"seq_len": 2, "size": 32, "classes": 8}


def port_model(kw: dict) -> dict:
    """The port's ``FactModel`` keyword arguments of a JAX one."""
    return dict(kw, image_size=INPUTS["size"])


def jax_fact(kw: dict, spec: dict, path, seed: int = 3,
             train: bool = True) -> dict:
    """JAX's FACT ``kw`` on ``W.fact_inputs(spec)``, in train mode (at
    dropout 0: the MoE's aux term sown) unless ``train`` is false: its
    weights converted and saved at ``path`` → the spec for ``W.fact_form``
    and the reference (``logits``, ``loss``, ``aux``, ``grads``)."""
    images, feats, labels = W.fact_inputs({**INPUTS, **spec})
    x, f = jnp.asarray(images), jnp.asarray(feats)
    jm = JaxFact(dtype=jnp.float32, **kw)
    variables = numpy_variables(jm, x, f, seed=seed)

    def loss(params):
        logits, mut = jm.apply({"params": params}, x, f, train=train,
                               mutable=["losses"],
                               rngs={"dropout": jax.random.key(0)})
        aux = sum((jnp.sum(v) for v in jax.tree.leaves(mut)),
                  jnp.float32(0))
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels, jnp.int32)).mean()
        return ce + aux, (logits, aux)

    (value, (logits, aux)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    torch.save(from_jax_variables(variables), str(path))
    return {"spec": {**INPUTS, **spec, "model": port_model(kw),
                     "weights": str(path)},
            "logits": np.asarray(logits), "loss": float(value),
            "aux": float(aux),
            "grads": from_jax_variables(
                {"params": jax.tree.map(np.asarray, grads)})}


def assert_grads(got: dict, want: dict, rtol: float, atol: float) -> None:
    """Every parameter's gradient, by name, within ``rtol``/``atol``."""
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)
