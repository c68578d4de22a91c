"""zero123plus conditioning: the UNet's cross-attention context, ported
from ``surya_tpu/models/diffusion/conditioning.py``.

Upstream (the pipeline the reference drives at
``Zero123/batch_aug.py:59-67``), the context fed to every cross-attention
layer is

    encoder_hidden_states = prompt_embeds("" empty prompt, CLIP text)
                            + ramp[None, :, None] * image_embeds[:, None, :]

where ``image_embeds`` is the CLIP-vision projection of the clean
conditioning image and ``ramp`` is the checkpoint's learned per-token
``ramping_coefficients`` (length = text sequence, 77).
:func:`combine_conditioning` is that math; :func:`clip_conditioning_fn`
wires it to CLIP encoders the caller supplies as callables (the card's
machine has no ``transformers``, and no CLIP weights are in the
repository).
"""

from __future__ import annotations

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def combine_conditioning(prompt_embeds, image_embeds, ramp):
    """(B,S,D) text embeds + (B,D) image embeds + (S,) ramp → (B,S,D)."""
    prompt_embeds = torch.as_tensor(prompt_embeds)
    image_embeds = torch.as_tensor(image_embeds)
    ramp = torch.as_tensor(ramp)
    if ramp.shape[0] != prompt_embeds.shape[1]:
        raise ValueError(
            f"ramp length {ramp.shape[0]} != token count "
            f"{prompt_embeds.shape[1]}")
    return prompt_embeds + image_embeds[:, None, :] * ramp[None, :, None]


def clip_conditioning_fn(text_encoder, vision_encoder, empty_prompt_ids,
                         ramp, image_proj=None):
    """Build ``image (B,H,W,3) in [0,1] → encoder_hidden_states``.

    - ``text_encoder(ids (1, S)) → (1, S, D)`` last hidden states (or an
      output with ``last_hidden_state``);
    - ``vision_encoder(pixel_values (B, 3, H, W), CLIP-normalised)`` → an
      output with ``image_embeds``, or with ``pooler_output`` (projected
      by ``image_proj`` (D_vis, D_txt) when given), or the pooled (B, D)
      tensor itself;
    - ``empty_prompt_ids``: (1, S) tokenized "" (no vocabulary is read);
    - ``ramp``: the checkpoint's ramping_coefficients, length S.

    Runs once per image, off the sampler's loop."""
    out = text_encoder(torch.as_tensor(empty_prompt_ids))
    prompt_embeds = getattr(out, "last_hidden_state", out)

    def fn(image):
        image = torch.as_tensor(image)
        mean = image.new_tensor(CLIP_MEAN)
        std = image.new_tensor(CLIP_STD)
        px = ((image - mean) / std).permute(0, 3, 1, 2)
        res = vision_encoder(px)
        embeds = getattr(res, "image_embeds", None)
        if embeds is None:
            embeds = getattr(res, "pooler_output", res)
            if image_proj is not None:
                embeds = embeds @ torch.as_tensor(image_proj).to(embeds)
        b = embeds.shape[0]
        return combine_conditioning(
            prompt_embeds.to(embeds).expand(b, *prompt_embeds.shape[1:]),
            embeds, torch.as_tensor(ramp).to(embeds))

    return fn
