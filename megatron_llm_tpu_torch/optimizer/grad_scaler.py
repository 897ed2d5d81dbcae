"""Loss scaling for fp16 (port of optimizer/grad_scaler.py).

`DynamicGradScaler` grows the scale by `growth_factor` after
`growth_interval` clean steps in a row and backs it off by
`backoff_factor` on overflow once `hysteresis` overflows have been seen
(the reference's rule, JAX :53-125). The state is a dict of 0-d tensors
on the params' device, updated with `torch.where`, so a step reads
nothing back to the host; `state_dict` / `load_state_dict` use the JAX
package's keys ("scale", "growth_tracker", "hysteresis_tracker").
"""

from __future__ import annotations

import torch


class ConstantGradScaler:
    def __init__(self, scale: float):
        self._scale = float(scale)

    def init_state(self, device=None) -> dict:
        return {}

    def scale(self, state) -> float:
        return self._scale

    def update(self, state, found_inf):
        return state

    def state_dict(self, state) -> dict:
        return {"scale": self._scale}

    def load_state_dict(self, state, sd):
        self._scale = float(sd["scale"])
        return state


class DynamicGradScaler:
    def __init__(self, initial_scale: float = 2.0 ** 32,
                 min_scale: float = 1.0, growth_factor: float = 2.0,
                 backoff_factor: float = 0.5, growth_interval: int = 1000,
                 hysteresis: int = 2):
        if not (initial_scale > 0 and min_scale > 0):
            raise ValueError("loss scales must be positive")
        if not (growth_factor > 1.0 and 0.0 < backoff_factor < 1.0):
            raise ValueError("need growth_factor > 1 and 0 < backoff < 1")
        self.initial_scale = initial_scale
        self.min_scale = min_scale
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval
        self.hysteresis = hysteresis

    def init_state(self, device=None) -> dict:
        return {
            "scale": torch.tensor(self.initial_scale, dtype=torch.float32,
                                  device=device),
            "growth_tracker": torch.zeros((), dtype=torch.int32,
                                          device=device),
            "hysteresis_tracker": torch.tensor(self.hysteresis,
                                               dtype=torch.int32,
                                               device=device),
        }

    def scale(self, state) -> torch.Tensor:
        return state["scale"]

    def update(self, state, found_inf) -> dict:
        """The reference's rule (JAX :63-86): an overflow zeroes the
        growth tracker and takes one off the hysteresis tracker; once
        that is <= 0 every overflow backs the scale off (to no less than
        `min_scale`); `growth_interval` clean steps in a row grow the
        scale and restore the hysteresis."""
        found_inf = torch.as_tensor(found_inf).to(torch.bool)
        scale = state["scale"]
        hyst = torch.where(found_inf, state["hysteresis_tracker"] - 1,
                           state["hysteresis_tracker"])
        backoff = found_inf & (hyst <= 0)
        new_scale = torch.where(
            backoff,
            torch.clamp(scale * self.backoff_factor, min=self.min_scale),
            scale)
        growth = torch.where(found_inf, torch.zeros_like(
            state["growth_tracker"]), state["growth_tracker"] + 1)
        grow = ~found_inf & (growth == self.growth_interval)
        new_scale = torch.where(grow, new_scale * self.growth_factor,
                                new_scale)
        growth = torch.where(grow, torch.zeros_like(growth), growth)
        hyst = torch.where(grow, torch.full_like(hyst, self.hysteresis),
                           hyst)
        return {"scale": new_scale, "growth_tracker": growth,
                "hysteresis_tracker": hyst}

    def state_dict(self, state) -> dict:
        return {k: float(v) if k == "scale" else int(v)
                for k, v in state.items()}

    def load_state_dict(self, state, sd) -> dict:
        device = state["scale"].device if state else None
        return {
            "scale": torch.tensor(float(sd["scale"]), dtype=torch.float32,
                                  device=device),
            "growth_tracker": torch.tensor(int(sd["growth_tracker"]),
                                           dtype=torch.int32, device=device),
            "hysteresis_tracker": torch.tensor(
                int(sd["hysteresis_tracker"]), dtype=torch.int32,
                device=device),
        }
