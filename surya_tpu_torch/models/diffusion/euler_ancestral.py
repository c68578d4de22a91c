"""Euler-Ancestral diffusion sampling on the card, ported from
``surya_tpu/models/diffusion/euler_ancestral.py``.

The reference's multiview stage drives ``sudo-ai/zero123plus`` through
diffusers with an ``EulerAncestralDiscreteScheduler`` in
``timestep_spacing='trailing'`` mode (``Zero123/batch_aug.py:59-67``).

- :class:`EulerAncestralSchedule` precomputes the schedule in numpy
  (scaled-linear betas, trailing/linspace/leading spacing, interpolated
  sigmas): the same code as JAX's, so the tables are bit-equal. The step
  math (``scale_model_input``, ``pred_original``, ``step``,
  ``add_noise``) runs on f32 tensors on the latents' device, sigmas taken
  from a device copy of the table (no host→device copy per step), in
  JAX's order of operations.
- :func:`sample` is a Python loop over the steps (JAX scans them). Every
  random draw is split from the math: the initial latents and each step's
  ancestral noise come from an explicit ``torch.Generator`` on the
  latents' device, or from draws the caller passes (a test feeds JAX's
  own: ``split(key)``, then ``k, kn = split(k)`` per step).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EulerAncestralSchedule:
    """Static schedule arrays for a fixed number of inference steps.

    sigmas has length num_steps+1 (final 0.0); timesteps has length
    num_steps (descending).
    """

    timesteps: np.ndarray
    sigmas: np.ndarray
    init_noise_sigma: float
    prediction_type: str  # "epsilon" | "v_prediction"
    _tables: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    @staticmethod
    def create(num_steps: int, num_train_timesteps: int = 1000,
               beta_start: float = 0.00085, beta_end: float = 0.012,
               beta_schedule: str = "scaled_linear",
               timestep_spacing: str = "trailing",
               steps_offset: int = 1,
               prediction_type: str = "epsilon") -> "EulerAncestralSchedule":
        if beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                                num_train_timesteps) ** 2
        elif beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps)
        else:
            raise ValueError(f"unknown beta_schedule {beta_schedule!r}")
        alphas_cumprod = np.cumprod(1.0 - betas)
        full_sigmas = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)

        T = num_train_timesteps
        if timestep_spacing == "trailing":
            # walk back from T in equal strides; hits T-1 exactly.
            # Closed-form (not np.arange(T, 0, -step)): float fuzz in
            # arange yields num_steps+1 entries with a trailing -1 for
            # ~6% of step counts (e.g. 61, 103).
            step = T / num_steps
            timesteps = (T - step * np.arange(num_steps)).round() - 1.0
        elif timestep_spacing == "linspace":
            timesteps = np.linspace(0, T - 1, num_steps)[::-1].copy()
        elif timestep_spacing == "leading":
            # diffusers applies the config's steps_offset (1 for the
            # SD/zero123plus family) in this mode only
            step = T // num_steps
            timesteps = (np.arange(num_steps) * step).round()[::-1].copy()
            timesteps += steps_offset
        else:
            raise ValueError(f"unknown timestep_spacing {timestep_spacing!r}")

        sigmas = np.interp(timesteps, np.arange(T), full_sigmas)
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        if timestep_spacing in ("linspace", "trailing"):
            init_noise_sigma = float(sigmas.max())
        else:
            init_noise_sigma = float((sigmas.max() ** 2 + 1) ** 0.5)
        return EulerAncestralSchedule(
            timesteps=timesteps.astype(np.float32), sigmas=sigmas,
            init_noise_sigma=init_noise_sigma,
            prediction_type=prediction_type)

    def table(self, name: str, device) -> torch.Tensor:
        """``sigmas`` or ``timesteps`` as an f32 tensor on ``device``,
        copied there once."""
        key = (name, str(torch.device(device)))
        if key not in self._tables:
            self._tables[key] = torch.as_tensor(getattr(self, name),
                                                device=device)
        return self._tables[key]

    def sigma(self, step_index: int, like: torch.Tensor) -> torch.Tensor:
        """The f32 sigma of a step, a 0-dim tensor on ``like``'s device."""
        return self.table("sigmas", like.device)[step_index]

    # -- tensor math, in JAX's order of operations -------------------------

    def scale_model_input(self, sample, step_index):
        sigma = self.sigma(step_index, sample)
        return sample / torch.sqrt(sigma ** 2 + 1.0)

    def pred_original(self, model_output, sample, sigma):
        if self.prediction_type == "epsilon":
            return sample - sigma * model_output
        if self.prediction_type == "v_prediction":
            # x0 = -v·sigma/sqrt(sigma²+1) + x/(sigma²+1)
            return (model_output * (-sigma / torch.sqrt(sigma ** 2 + 1.0))
                    + sample / (sigma ** 2 + 1.0))
        raise ValueError(self.prediction_type)

    def step(self, model_output, step_index, sample, noise):
        """One ancestral Euler step: x_{i+1} from x_i and the model
        output at sigma_i; ``noise`` is standard normal of x's shape."""
        sigmas = self.table("sigmas", sample.device)
        sigma_from = sigmas[step_index]
        sigma_to = sigmas[step_index + 1]
        x0 = self.pred_original(model_output, sample, sigma_from)
        sigma_up = torch.sqrt(
            sigma_to ** 2 * (sigma_from ** 2 - sigma_to ** 2)
            / sigma_from ** 2)
        sigma_down = torch.sqrt(sigma_to ** 2 - sigma_up ** 2)
        derivative = (sample - x0) / sigma_from
        prev = sample + derivative * (sigma_down - sigma_from)
        return prev + noise * sigma_up

    def add_noise(self, clean, noise, step_index):
        """Forward-noise clean data to the given step's sigma
        (img2img/strength entry point)."""
        return clean + noise * self.sigma(step_index, clean)


def sample(schedule: EulerAncestralSchedule, denoiser: Callable, shape,
           *, generator: Optional[torch.Generator] = None,
           init_latents: Optional[torch.Tensor] = None,
           init_noise: Optional[torch.Tensor] = None,
           step_noise: Optional[Sequence[torch.Tensor]] = None
           ) -> torch.Tensor:
    """The whole trajectory, one Python step at a time.

    ``denoiser(scaled_latents, t, i) -> model_output``, with t the f32
    train-timestep of step i (a 0-dim tensor) and i the step index. Starts
    from ``init_latents`` (already noised via :meth:`add_noise`), else
    from ``init_noise`` (standard normal) or a draw from ``generator``,
    scaled by ``init_noise_sigma``. Each step's ancestral noise is
    ``step_noise[i]`` or a draw from ``generator``. The trajectory runs on
    the generator's device, else on that of the draws given."""

    def draw(n=None):
        if n is not None:
            return n.float()
        if generator is None:
            raise ValueError("sample needs a generator or the draws")
        return torch.randn(shape, generator=generator,
                           device=generator.device, dtype=torch.float32)

    if init_latents is None:
        init_latents = draw(init_noise) * schedule.init_noise_sigma
    latents = init_latents.float()
    timesteps = schedule.table("timesteps", latents.device)
    for i in range(len(schedule.timesteps)):
        scaled = schedule.scale_model_input(latents, i)
        out = denoiser(scaled, timesteps[i], i)
        noise = draw(None if step_noise is None else step_noise[i])
        latents = schedule.step(out, i, latents, noise)
    return latents
