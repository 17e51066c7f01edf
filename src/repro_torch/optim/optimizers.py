"""SGD (+momentum) and AdamW as transformations of flat tensor dicts
(port of ``repro.optim.optimizers``).

API mirrors the reference (and optax): ``opt = sgd(lr); state =
opt.init(params); updates, state = opt.update(grads, state, params);
params = apply_updates(params, updates)``. Params, grads and updates
are the port's flat ``dict[str, Tensor]``. Dtypes follow the reference:
AdamW's moments are f32 and its updates cast to the param's dtype; SGD's
updates and momentum keep the grads' dtype. Every function returns new
tensors; nothing is updated in place. The paper trains satellites with
plain mini-batch SGD (lr 0.01); AdamW is there for LM-scale federated
pre-training.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, NamedTuple

import torch

Tree = Mapping[str, torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    mu: Any = None       # first moment / momentum
    nu: Any = None       # second moment


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], OptState]
    update: Callable[..., tuple[dict, OptState]]


def _step0(params: Tree) -> torch.Tensor:
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(learning_rate: float, momentum: float = 0.0) -> Optimizer:
    def init(params: Tree) -> OptState:
        mu = ({k: torch.zeros_like(p) for k, p in params.items()}
              if momentum else None)
        return OptState(step=_step0(params), mu=mu)

    def update(grads: Tree, state: OptState, params: Tree | None = None):
        del params
        if momentum:
            mu = {k: momentum * state.mu[k] + g for k, g in grads.items()}
            upd = {k: -learning_rate * m for k, m in mu.items()}
            return upd, OptState(state.step + 1, mu=mu)
        upd = {k: -learning_rate * g for k, g in grads.items()}
        return upd, OptState(state.step + 1)

    return Optimizer(init, update)


def adamw(
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params: Tree) -> OptState:
        return OptState(
            step=_step0(params),
            mu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()},
        )

    def update(grads: Tree, state: OptState, params: Tree):
        step = state.step + 1
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()
        mu = {k: b1 * state.mu[k] + (1 - b1) * g.float()
              for k, g in grads.items()}
        nu = {k: b2 * state.nu[k] + (1 - b2) * torch.square(g.float())
              for k, g in grads.items()}

        def upd_leaf(m, v, p):
            step_ = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                step_ = step_ + weight_decay * p.float()
            return (-learning_rate * step_).to(p.dtype)

        upd = {k: upd_leaf(mu[k], nu[k], params[k]) for k in grads}
        return upd, OptState(step, mu=mu, nu=nu)

    return Optimizer(init, update)


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> tuple[dict, torch.Tensor]:
    """Returns (clipped grads, pre-clip global norm). The norm is summed
    over the leaves in dict order, in f32; each leaf is scaled in f32 and
    cast back to its dtype, as the reference's f32 scale promotes it."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype)
            for k, g in grads.items()}, gn


def apply_updates(params: Tree, updates: Tree) -> dict:
    return {k: p + updates[k] for k, p in params.items()}
