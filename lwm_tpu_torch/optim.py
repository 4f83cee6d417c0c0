"""AdamW with optax's exact semantics (`lwm_tpu/optim.py:17-97`).

`OptimizerFactory.get_optimizer` builds, as the JAX factory does,
`optax.chain(clip_by_global_norm(clip_gradient), optax.adamw(schedule, b1,
b2, eps=1e-8, weight_decay, mask, mu_dtype))`, inside `optax.MultiSteps`
when `accumulate_gradient_steps > 1`. What that means, step by step, and
where torch's own tools differ (so they are not used):
- the schedule (`warmup_cosine_decay_schedule`) is read at the count of
  updates applied BEFORE this one: with the default `init_lr = 0` the first
  update moves nothing, weight decay included;
- clipping scales every gradient by max/norm only when norm ≥ max, with no
  epsilon (`torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6);
- Adam: mu = (1−b1)·g + b1·mu, nu = (1−b2)·g² + b2·nu, bias-corrected by
  1 − b^count in fp32, update = mu_hat / (sqrt(nu_hat) + eps) — eps outside
  the root; with `bf16_momentum` b1 itself is rounded to bf16 in b1·mu
  (optax's weakly typed constant: 0.8984375), the product is kept in fp32
  as XLA keeps it (excess precision), and mu is stored back in bf16;
- decoupled weight decay adds wd·p to the update of every param (the text
  model's mask keeps all: `get_weight_decay_exclusions() == ()`), then the
  update is scaled by −lr and added to p;
- MultiSteps keeps the running mean of k micro-batch gradients (Welford:
  acc + (g − acc)/(n + 1)) and applies it every k-th call.
The update is a loop over tensors with per-tensor temporaries (no
`foreach`: torch's multi-tensor path allocates whole-model temporaries that
a 7b-width model on one card cannot afford). `named_state` and
`load_named_state` carry the state by parameter name, the layout
`utils/convert.py` maps to and from optax's. Not ported yet: the PaLM
optimizer (Adafactor; its config subtree is kept so the JAX flags parse),
weight-decay masks that exclude params and frozen-parameter masks (the
vision slice).
"""

from __future__ import annotations

import numpy as np
import torch

from lwm_tpu_torch.utils.flags import merge_config
from lwm_tpu_torch.utils.losses import global_norm

EPS = 1e-8  # optax.adamw's default, outside the square root


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps, decay_steps,
                                 end_value=0.0, exponent=1.0):
    """`optax.warmup_cosine_decay_schedule`: linear from init_value to
    peak_value over warmup_steps, then a cosine to end_value at decay_steps,
    constant after. Returns count → learning rate (a float), computed in
    fp32 in optax's order of operations (at step 1 of the default 2000-step
    warm-up that is 5.000271e-06, not 5e-06)."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(count):
        count = int(count)
        if warmup_steps > 0 and count < warmup_steps:
            frac = f32(1) - f32(max(count, 0)) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        c = f32(min(count - warmup_steps, cos_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(cos_steps)))
        return float(f32(peak_value) * (f32(1 - alpha) * cosine ** f32(exponent) + f32(alpha)))

    return schedule


class AdamW(torch.optim.Optimizer):
    """clip_by_global_norm + optax.adamw (+ MultiSteps), see the module
    note. `named_params`: (name, tensor) pairs, every one decayed. Call
    `step()` once per micro-batch after `backward()`; a param whose `.grad`
    is None counts as a zero gradient."""

    def __init__(self, named_params, *, learning_rate_schedule, b1=0.9, b2=0.95,
                 weight_decay=1e-4, clip_gradient=1.0, mu_dtype=torch.float32,
                 accumulate_gradient_steps=1):
        named_params = list(named_params)
        super().__init__([p for _, p in named_params], dict(weight_decay=weight_decay))
        self.names = {p: n for n, p in named_params}
        self.schedule = learning_rate_schedule
        self.b1, self.b2, self.weight_decay = b1, b2, weight_decay
        self.clip_gradient = clip_gradient
        self.mu_dtype = mu_dtype
        # b1 in mu's dtype (0.8984375 for bf16), the factor optax's b1·mu uses
        self._b1_mu = float(torch.tensor(b1, dtype=mu_dtype))
        self.k = accumulate_gradient_steps
        self.count = 0          # updates applied (optax's adam and schedule counts)
        self.mini_step = 0      # MultiSteps: micro-batches folded into acc
        self.gradient_step = 0  # MultiSteps: updates emitted

    def _params(self):
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("AdamW.step takes no closure")
        params = self._params()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if self.k > 1:
            n = self.mini_step
            for p, g in zip(params, grads):
                st = self.state[p]
                if "acc" not in st:
                    st["acc"] = torch.zeros_like(p)
                st["acc"].add_((g - st["acc"]) / (n + 1))
            if n < self.k - 1:
                self.mini_step += 1
                return
            grads = [self.state[p]["acc"] for p in params]
        self._update(params, grads)
        if self.k > 1:
            for g in grads:
                g.zero_()
            self.mini_step = 0
            self.gradient_step += 1

    def _update(self, params, grads):
        b1, b2 = self.b1, self.b2
        norm = global_norm(grads)
        clip = not bool(norm < self.clip_gradient)
        count = self.count + 1
        # 1 − decay^count in fp32, as optax's bias correction
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        neg_lr = -float(np.float32(self.schedule(self.count)))
        for p, g in zip(params, grads):
            st = self.state[p]
            if "mu" not in st:
                st["mu"] = torch.zeros_like(p, dtype=self.mu_dtype)
                st["nu"] = torch.zeros_like(p)
            if clip:
                g = g / norm * self.clip_gradient
            mu = g * (1 - b1) + st["mu"].float() * self._b1_mu
            nu = st["nu"]
            nu.copy_(g.square().mul_(1 - b2) + nu * b2)
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(EPS))
            if self.weight_decay:
                u.add_(p * self.weight_decay)
            p.add_(u.mul_(neg_lr))
            st["mu"] = mu.to(self.mu_dtype)
        self.count = count

    def named_state(self):
        """{"count", "mini_step", "gradient_step", "mu", "nu", "acc"} with
        per-param dicts keyed by parameter name (the layout
        `utils.convert.convert_optax_state` produces)."""
        out = dict(count=self.count, mini_step=self.mini_step, gradient_step=self.gradient_step)
        for key in ("mu", "nu", "acc"):
            out[key] = {self.names[p]: s[key] for p, s in self.state.items() if key in s}
        return out

    @torch.no_grad()
    def load_named_state(self, named):
        """The inverse of `named_state`: counts and per-parameter moments
        (and the MultiSteps accumulator) by parameter name, each copied to
        its parameter's device in the optimizer's own dtype (mu_dtype for
        mu, the parameter's for nu and acc), as the JAX trainer casts a
        loaded state to its target's dtypes. A moment missing from `named`
        is left unset (zeros at the first update)."""
        self.count = int(named["count"])
        self.mini_step = int(named.get("mini_step", 0))
        self.gradient_step = int(named.get("gradient_step", 0))
        for p in self._params():
            for key in ("mu", "nu", "acc"):
                value = named.get(key, {}).get(self.names[p])
                if value is not None:
                    dtype = self.mu_dtype if key == "mu" else p.dtype
                    self.state[p][key] = torch.as_tensor(value).to(p.device, dtype, copy=True)


ADAMW_DEFAULTS = dict(
    init_lr=0.0, end_lr=0.001, lr=0.01, lr_warmup_steps=2000, lr_decay_steps=500000,
    b1=0.9, b2=0.95, clip_gradient=1.0, weight_decay=1e-4, bf16_momentum=False,
    multiply_by_parameter_scale=False,
)
# `lwm_tpu/optim.py:118-128`: kept so that the JAX flag tree parses; the
# PaLM optimizer itself is not ported (type "palm" raises)
PALM_DEFAULTS = dict(lr=0.01, lr_warmup_steps=10000, b1=0.9, b2=0.99, clip_gradient=1.0,
                     weight_decay=1e-4, bf16_momentum=False)


class OptimizerFactory:
    """`lwm_tpu/optim.py:17-53` with nested dicts for `ml_collections`."""

    @staticmethod
    def get_default_config(updates=None):
        return merge_config(
            dict(accumulate_gradient_steps=1, type="adamw", palm_optimizer=PALM_DEFAULTS,
                 adamw_optimizer=ADAMW_DEFAULTS),
            updates, "optimizer",
        )

    @classmethod
    def get_optimizer(cls, config, named_params):
        """AdamW over `named_params` ((name, tensor) pairs, all decayed: the
        text model's weight-decay mask keeps every param); its schedule is
        `.schedule`."""
        config = cls.get_default_config(config)
        if config["type"] != "adamw":
            raise NotImplementedError(
                f"optimizer {config['type']!r} is not ported yet (adamw is; the PaLM "
                "optimizer goes with the vision finetune recipes, ROADMAP A5)")
        c = config["adamw_optimizer"]
        schedule = warmup_cosine_decay_schedule(
            c["init_lr"], c["lr"], c["lr_warmup_steps"], c["lr_decay_steps"], c["end_lr"]
        )
        return AdamW(
            named_params, learning_rate_schedule=schedule, b1=c["b1"], b2=c["b2"],
            weight_decay=c["weight_decay"], clip_gradient=c["clip_gradient"],
            mu_dtype=torch.bfloat16 if c["bf16_momentum"] else torch.float32,
            accumulate_gradient_steps=config["accumulate_gradient_steps"],
        )
