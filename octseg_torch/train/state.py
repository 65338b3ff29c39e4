"""Train state and optimizers (the port of octseg/train/state.py).

octseg builds its optimizers as optax chains; the port applies the same
formulas in plain torch, because torch.optim's differ:

- weight decay is coupled L2, added to the gradient first
  (``optax.add_decayed_weights``), for every optimizer but SAdam;
- SGD: u = g;
- RMSprop (decay 0.99, eps 1e-8): nu = 0.01 g^2 + 0.99 nu,
  u = g / sqrt(nu + eps), eps INSIDE the square root (torch puts it outside);
- Adam (b1 0.9, b2 0.999, eps 1e-8): bias-corrected moments,
  u = mu_hat / (sqrt(nu_hat) + eps);
- RAdam: optax's ``scale_by_radam`` (threshold 5 on rho_t, eps outside the
  root, plain bias-corrected momentum below the threshold), which torch's
  RAdam places otherwise;
- SAdam: Adam, ignoring the weight decay;

then p <- p - lr u. The per-step scalars (decay ** t, rho_t, the rectifier)
are computed in float32 in optax's order, so both packages take the same
branch and the same step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch
from torch import nn

OPTIMIZERS = ('SGD', 'RMSprop', 'RAdam', 'Adam', 'SAdam')
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
_RMS_DECAY = 0.99
_RADAM_THRESHOLD = 5.0

f32 = np.float32


class Optimizer:
    """One of octseg's optax chains, applied in place to a list of float32
    parameters. ``init`` makes the state; ``step`` applies one update."""

    def __init__(self, name: str, lr: float, weight_decay: float = 0.0):
        if name not in OPTIMIZERS:
            raise ValueError(f'Unknown optimizer: {name}')
        self.name = name
        self.lr = float(lr)
        self.weight_decay = 0.0 if name == 'SAdam' else float(weight_decay or 0.0)

    def init(self, params: List[torch.Tensor]) -> Dict[str, object]:
        state: Dict[str, object] = {'count': 0}
        if self.name in ('RMSprop', 'RAdam', 'Adam', 'SAdam'):
            state['nu'] = [torch.zeros_like(p) for p in params]
        if self.name in ('RAdam', 'Adam', 'SAdam'):
            state['mu'] = [torch.zeros_like(p) for p in params]
        return state

    def _scalars(self, t: int) -> Dict[str, float]:
        """float32 bias corrections and RAdam's rectifier for step t."""
        b1t, b2t = f32(_B1) ** f32(t), f32(_B2) ** f32(t)
        out = {'bc1': float(f32(1) - b1t), 'bc2': float(f32(1) - b2t)}
        if self.name == 'RAdam':
            ro_inf = 2.0 / (1.0 - _B2) - 1.0
            ro = f32(ro_inf) - f32(2 * t) * b2t / (f32(1) - b2t)
            out['rectify'] = bool(ro >= _RADAM_THRESHOLD)
            if out['rectify']:
                r2 = (ro - f32(4)) * (ro - f32(2)) * f32(ro_inf) / (
                    f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)
                out['r'] = float(np.sqrt(r2))
        return out

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             state: Dict[str, object]) -> None:
        state['count'] = t = int(state['count']) + 1
        s = self._scalars(t)
        neg_lr = -self.lr
        for i, (p, g) in enumerate(zip(params, grads)):
            if self.weight_decay:
                g = g + self.weight_decay * p
            if self.name == 'SGD':
                u = g
            elif self.name == 'RMSprop':
                nu = state['nu'][i]
                nu.copy_((1 - _RMS_DECAY) * g ** 2 + _RMS_DECAY * nu)
                u = torch.rsqrt(nu + _EPS) * g
            else:
                mu, nu = state['mu'][i], state['nu'][i]
                mu.copy_((1 - _B1) * g + _B1 * mu)
                nu.copy_((1 - _B2) * g ** 2 + _B2 * nu)
                mu_hat = mu / s['bc1']
                if self.name == 'RAdam' and not s['rectify']:
                    u = mu_hat
                else:
                    num = s['r'] * mu_hat if self.name == 'RAdam' else mu_hat
                    u = num / (torch.sqrt(nu / s['bc2']) + _EPS)
            p.add_(neg_lr * u)


def make_optimizer(name: str, lr: float, weight_decay: float = 0.0) -> Optimizer:
    return Optimizer(name, lr, weight_decay)


@dataclass
class TrainState:
    """Step count, the model (parameters and BatchNorm statistics) and the
    optimizer with its state."""

    model: nn.Module
    tx: Optimizer
    opt_state: Dict[str, object] = field(default_factory=dict)
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, tx: Optimizer) -> 'TrainState':
        return cls(model=model, tx=tx, opt_state=tx.init(cls.params_of(model)))

    @staticmethod
    def params_of(model: nn.Module) -> List[torch.Tensor]:
        return list(model.parameters())

    def apply_gradients(self) -> None:
        """One optimizer update from the parameters' ``.grad``; clears them."""
        params = self.params_of(self.model)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        self.tx.step(params, grads, self.opt_state)
        for p in params:
            p.grad = None
        self.step += 1
