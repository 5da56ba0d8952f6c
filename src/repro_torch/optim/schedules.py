"""Learning-rate schedules (pure functions of the step).

`step` is an int tensor (the optimiser's 0-d step counter) or a Python
int; each returns a 0-d f32 tensor on the step's device, as the JAX
package's functions return a 0-d f32 array.
"""

from __future__ import annotations

import math

import torch


def linear_warmup(step, warmup_steps: int, peak_lr: float):
    step = torch.as_tensor(step)
    return peak_lr * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, final_frac: float = 0.1):
    step = torch.as_tensor(step)
    warm = linear_warmup(step, warmup_steps, peak_lr)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)
