"""The JAX trainer's optimizers with optax's exact semantics
(`lwm_tpu/optim.py`): AdamW and the PaLM optimizer (Adafactor).

`OptimizerFactory.get_optimizer` builds, as the JAX factory does, for
`type="adamw"` `optax.chain(clip_by_global_norm(clip_gradient),
optax.adamw(schedule, b1, b2, eps=1e-8, weight_decay, mask, mu_dtype))`,
for `type="palm"` `optax.chain(clip_by_global_norm(clip_gradient),
optax.adafactor(...), optax_add_scheduled_weight_decay(...))`, either inside
`optax.MultiSteps` when `accumulate_gradient_steps > 1`, and with a
frozen-parameter mask inside `optax.multi_transform({True: set_to_zero(),
False: ...})`. What that means, step by step, and where torch's own tools
differ (so they are not used):
- a schedule is read at the count of updates applied BEFORE this one:
  with AdamW's default `init_lr = 0` the first update moves nothing,
  weight decay included;
- clipping scales every gradient by max/norm only when norm ≥ max, with no
  epsilon (`torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6);
- Adam: mu = (1−b1)·g + b1·mu, nu = (1−b2)·g² + b2·nu, bias-corrected by
  1 − b^count in fp32, update = mu_hat / (sqrt(nu_hat) + eps) — eps outside
  the root; decoupled weight decay adds wd·p to the update of every
  decayed param, then the update is scaled by −lr and added to p;
- PaLM (`lwm_tpu/optim.py:100-176`, optax's `adafactor` with
  `factored=False`, `multiply_by_parameter_scale=True`, `momentum=b1`,
  `decay_rate=b2`, no clipping threshold): lr(step) = (lr / 0.01) /
  sqrt(max(step, lr_warmup_steps)) in fp32; v = d·v + (1 − d)·(g² + 1e-30)
  with d = 1 − (count + 1)^(−b2); u = g / sqrt(v) · lr(count) · max(rms(p),
  1e-3), rms over the param's block: optax takes it over a leaf of the
  JAX tree, and a scanned tree stacks each layer param of every layer in
  one leaf (`param_block`, `utils.convert.flax_param_path`); the momentum
  ema = (1 − b1)·u + b1·ema without debias; then −ema plus the scheduled
  weight decay −(weight_decay / 1e-4)·lr(count)²·p on decayed params,
  added to p. The unfactored second moment keeps optax's
  one-element `v_row`/`v_col` placeholders only in the checkpoint layout
  (`utils/convert.py`);
- with `bf16_momentum` the momentum (AdamW's mu, PaLM's ema) is stored in
  bf16 and b1 itself is rounded to bf16 in b1·m (optax's weakly typed
  constant: 0.8984375); the product is kept in fp32 as XLA keeps it
  (excess precision);
- MultiSteps keeps the running mean of k micro-batch gradients (Welford:
  acc + (g − acc)/(n + 1)) and applies it every k-th call;
- multi_transform: frozen params are not the optimizer's at all (no
  update, no moments, no decay), so the clip norm is over the trainable
  params' gradients only; the trainer's logged `gradient_norm` still
  counts every gradient, frozen ones included.
The masks are predicates on parameter names (`train.param_masks` matches
the config's exclusions against each param's flax path, as
`lwm_tpu/parallel/partition.py:174-212` does).

The update is a loop over tensors with per-tensor temporaries (no
`foreach`: torch's multi-tensor path allocates whole-model temporaries that
a 7b-width model on one card cannot afford). `named_state` and
`load_named_state` carry the state by parameter name, the layout
`utils/convert.py` maps to and from optax's.

On a mesh (`placements`: each parameter's `parallel.fsdp.Placement`) the
parameters are this rank's parts of the whole leaves, and so are the
moments: the updates run on the parts as they are elementwise; the clip
norm is the whole leaves' (`utils.losses.global_norm`, summed over the
shard group and tp), and PaLM's per-block rms is the whole leaf's, its
squares and sizes summed over the shard group and, for the leaves split
over tp, over tp. `named_state` gives the parts; `load_named_state` and
`load_moment` take whole leaves and keep this rank's parts.
"""

from __future__ import annotations

import collections
import math
import re

import numpy as np
import torch

from lwm_tpu_torch.utils.flags import merge_config
from lwm_tpu_torch.utils.losses import global_norm

EPS = 1e-8  # optax.adamw's default, outside the square root
FACTORED_EPS = 1e-30   # optax.adafactor's eps, added to g²
MIN_PARAM_RMS = 1e-3   # scale_by_param_block_rms's floor


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


def palm_schedule(lr, warmup_steps):
    """The PaLM learning rate (`lwm_tpu/optim.py:135-137`): count → (lr /
    0.01) / sqrt(max(count, warmup_steps)), in fp32."""
    def schedule(count):
        return float(np.float32(lr / 0.01) / np.sqrt(np.float32(max(int(count), warmup_steps))))

    return schedule


def none_match(rules):
    """A predicate on a flax param path: True where no regex of `rules`
    matches it. `get_weight_decay_mask(exclusions)` (decayed) and
    `get_frozen_base_mask(trainable_exclusions)` (frozen) are both this
    (`lwm_tpu/parallel/partition.py:174-212`)."""
    return lambda path: all(re.search(rule, path) is None for rule in rules)


class _Optimizer:
    """What both optimizers share: the parameters by name, the decay
    mask, MultiSteps, the global-norm clip and the state by name.
    Subclasses give `KIND` (the `utils.convert.optax_state_tree` layout),
    `MOMENTS` (their per-param state keys, the first kept in `mu_dtype`)
    and `_update`. Call `step()` once per micro-batch after
    `backward()`; a param whose `.grad` is None counts as a zero gradient."""

    KIND, MOMENTS = None, ()

    def __init__(self, named_params, *, learning_rate_schedule, b1, b2, weight_decay,
                 clip_gradient, mu_dtype=torch.float32, accumulate_gradient_steps=1,
                 weight_decay_mask=None, multi_transform=False, param_block=None,
                 placements=None):
        named_params = list(named_params)
        # param → its Placement on a mesh (None on one device)
        self.placement = None if placements is None else {p: placements[n]
                                                          for n, p in named_params}
        # the leaf of the JAX tree each param lies in (params of one share it)
        self.block = {p: n if param_block is None else param_block(n) for n, p in named_params}
        self.params = [p for _, p in named_params]   # none when every param is frozen
        self.state = collections.defaultdict(dict)   # param → its moments (and acc)
        self.names = {p: n for n, p in named_params}
        self.decayed = {p for n, p in named_params
                        if weight_decay_mask is None or weight_decay_mask(n)}
        self.schedule = learning_rate_schedule
        self.b1, self.b2, self.weight_decay = b1, b2, weight_decay
        self.clip_gradient = clip_gradient
        self.mu_dtype = mu_dtype
        # b1 in mu's dtype (0.8984375 for bf16), the factor optax's b1·mu uses
        self._b1_mu = float(torch.tensor(b1, dtype=mu_dtype))
        self.k = accumulate_gradient_steps
        self.multi_transform = multi_transform   # a frozen mask was given (the state's layout)
        self.count = 0          # updates applied (optax's counts: moments, schedules)
        self.mini_step = 0      # MultiSteps: micro-batches folded into acc
        self.gradient_step = 0  # MultiSteps: updates emitted

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError(f"{type(self).__name__}.step takes no closure")
        # the span name torch.optim.Optimizer gives a step in a profile
        with torch.profiler.record_function(f"Optimizer.step#{type(self).__name__}.step"):
            self._step()

    def _step(self):
        params = self.params
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
        if params:
            norm = global_norm(grads, None if self.placement is None
                               else [self.placement[p] for p in params])
            clip = None if bool(norm < self.clip_gradient) else (norm, self.clip_gradient)
            self._update(params, grads, clip)
        self.count += 1
        if self.k > 1:
            for g in grads:
                g.zero_()
            self.mini_step = 0
            self.gradient_step += 1

    def _local(self, p, value):
        """A whole leaf of param `p`'s shape → this rank's part of it."""
        value = torch.as_tensor(value)
        if self.placement is None or tuple(value.shape) == tuple(p.shape):
            return value
        return self.placement[p].local_part(value)

    @staticmethod
    def _clipped(g, clip):
        """g scaled by max/norm when `clip` = (norm, max), one tensor at a time."""
        return g if clip is None else g / clip[0] * clip[1]

    def _moment(self, p, key, dtype=None):
        st = self.state[p]
        if key not in st:
            st[key] = torch.zeros_like(p, dtype=dtype)
        return st[key]

    def named_state(self):
        """{"count", "mini_step", "gradient_step", *MOMENTS, "acc"} with
        per-param dicts keyed by parameter name (the layout
        `utils.convert.convert_optax_state` produces)."""
        out = dict(count=self.count, mini_step=self.mini_step, gradient_step=self.gradient_step)
        for key in (*self.MOMENTS, "acc"):
            out[key] = {self.names[p]: s[key] for p, s in self.state.items() if key in s}
        return out

    @torch.no_grad()
    def load_named_state(self, named):
        """The inverse of `named_state`: counts and per-parameter moments
        (and the MultiSteps accumulator) by parameter name, each copied to
        its parameter's device in the optimizer's own dtype (mu_dtype for
        the momentum, the parameter's for the rest), as the JAX trainer
        casts a loaded state to its target's dtypes; a whole leaf on a mesh
        is cut to this rank's part. A moment missing from `named` is left
        unset (zeros at the first update); a state of the other optimizer
        raises."""
        if not set(self.MOMENTS) <= named.keys():
            raise ValueError(f"{type(self).__name__} cannot load an optimizer state holding "
                             f"{sorted(k for k in named if isinstance(named[k], dict))}")
        self.load_counts(named)
        by_name = {n: p for p, n in self.names.items()}
        for key in (*self.MOMENTS, "acc"):
            for name, value in named.get(key, {}).items():
                if name in by_name:
                    self.load_moment(key, name, value)

    def load_counts(self, named):
        """The counts of a `named_state` ("count", "mini_step", "gradient_step")."""
        self.count = int(named["count"])
        self.mini_step = int(named.get("mini_step", 0))
        self.gradient_step = int(named.get("gradient_step", 0))

    @torch.no_grad()
    def load_moment(self, key, name, value):
        """Set moment `key` of parameter `name` from its whole leaf `value`
        (this rank's part of it, on the parameter's device, in the
        optimizer's dtype: see `load_named_state`)."""
        p = next(q for q, n in self.names.items() if n == name)
        dtype = self.mu_dtype if key == self.MOMENTS[0] else p.dtype
        self.state[p][key] = self._local(p, value).to(p.device, dtype, copy=True)


class AdamW(_Optimizer):
    """clip_by_global_norm + optax.adamw (+ MultiSteps), see the module note."""

    KIND, MOMENTS = "adamw", ("mu", "nu")

    def _update(self, params, grads, clip):
        b1, b2 = self.b1, self.b2
        count = self.count + 1
        # 1 − decay^count in fp32, as optax's bias correction
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        neg_lr = -float(np.float32(self.schedule(self.count)))
        for p, g in zip(params, grads):
            g = self._clipped(g, clip)
            mu = g * (1 - b1) + self._moment(p, "mu", self.mu_dtype).float() * self._b1_mu
            nu = self._moment(p, "nu")
            nu.copy_(g.square().mul_(1 - b2) + nu * b2)
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(EPS))
            if self.weight_decay and p in self.decayed:
                u.add_(p * self.weight_decay)
            p.add_(u.mul_(neg_lr))
            self.state[p]["mu"] = mu.to(self.mu_dtype)


class Palm(_Optimizer):
    """clip_by_global_norm + optax.adafactor as the PaLM factory sets it +
    the scheduled weight decay (+ MultiSteps), see the module note."""

    KIND, MOMENTS = "palm", ("ema", "v")

    def _update(self, params, grads, clip):
        f32 = np.float32
        decay = f32(1) - f32(self.count + 1) ** f32(-self.b2)
        lr = f32(self.schedule(self.count))
        wd = float(f32(-(self.weight_decay / 1e-4)) * (lr * lr))
        rms = self._block_rms(params)
        for p, g in zip(params, grads):
            g = self._clipped(g, clip)
            v = self._moment(p, "v")
            v.copy_(v * float(decay) + g.square().add_(FACTORED_EPS).mul_(float(f32(1) - decay)))
            u = (g * v.rsqrt()).mul_(float(lr))
            u.mul_(rms[self.block[p]])
            ema = u.mul_(1 - self.b1).add_(
                self._moment(p, "ema", self.mu_dtype).float() * self._b1_mu)
            self.state[p]["ema"] = ema.to(self.mu_dtype, copy=True)
            update = ema.neg_()
            if p in self.decayed:
                update.add_(p * wd)
            p.add_(update)


    def _block_rms(self, params):
        """{block: max(rms of its whole leaf, MIN_PARAM_RMS)} before any
        update; on a mesh the squares and sizes of the parts are summed over
        the shard group and, for leaves split over tp, over tp."""
        squares, sizes, split = {}, {}, {}   # each block's sum of squares, size, splits
        for p in params:
            b = self.block[p]
            squares[b] = squares.get(b, 0.0) + p.float().square().sum()
            pl = None if self.placement is None else self.placement[p]
            sizes[b] = sizes.get(b, 0) + (p.numel() if pl is None else math.prod(pl.shape))
            split[b] = (False, False) if pl is None else (pl.over_tp, pl.over_shard)
        blocks = list(squares)
        mesh = None if self.placement is None or not blocks else self.placement[params[0]].mesh
        if mesh is not None:
            sums = torch.stack([squares[b] for b in blocks])
            for axis, m, n in (("shard", 1, mesh.shard), ("tp", 0, mesh.tp)):
                if n > 1:
                    on = torch.tensor([split[b][m] for b in blocks], device=sums.device)
                    sums = torch.where(on, mesh.all_reduce(sums, axis), sums)
            squares = dict(zip(blocks, sums.unbind(0)))
        return {b: (squares[b] / sizes[b]).sqrt().clamp_min(MIN_PARAM_RMS) for b in blocks}


ADAMW_DEFAULTS = dict(
    init_lr=0.0, end_lr=0.001, lr=0.01, lr_warmup_steps=2000, lr_decay_steps=500000,
    b1=0.9, b2=0.95, clip_gradient=1.0, weight_decay=1e-4, bf16_momentum=False,
    multiply_by_parameter_scale=False,
)
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
    def get_optimizer(cls, config, named_params, weight_decay_mask=None,
                      frozen_param_mask=None, param_block=None, placements=None):
        """The optimizer of `config["type"]` over `named_params` ((name,
        tensor) pairs): `weight_decay_mask(name)` says whether a param is
        decayed (all when None), `frozen_param_mask(name)` whether it is
        frozen (none when None; frozen params are left out),
        `param_block(name)` names the JAX tree leaf a param lies in (PaLM's
        parameter scale is one a leaf; each param its own when None),
        `placements` ({name: `parallel.fsdp.Placement`}) how a mesh holds
        them (the module note). Its schedule is `.schedule`."""
        config = cls.get_default_config(config)
        named_params = list(named_params)
        if frozen_param_mask is not None:
            named_params = [(n, p) for n, p in named_params if not frozen_param_mask(n)]
        common = dict(accumulate_gradient_steps=config["accumulate_gradient_steps"],
                      weight_decay_mask=weight_decay_mask,
                      multi_transform=frozen_param_mask is not None, param_block=param_block,
                      placements=placements)
        if config["type"] == "adamw":
            c = config["adamw_optimizer"]
            schedule = warmup_cosine_decay_schedule(
                c["init_lr"], c["lr"], c["lr_warmup_steps"], c["lr_decay_steps"], c["end_lr"])
            cls_ = AdamW
        elif config["type"] == "palm":
            c = config["palm_optimizer"]
            schedule = palm_schedule(c["lr"], c["lr_warmup_steps"])
            cls_ = Palm
        else:
            raise ValueError(f"unknown optimizer type: {config['type']}")
        return cls_(
            named_params, learning_rate_schedule=schedule, b1=c["b1"], b2=c["b2"],
            weight_decay=c["weight_decay"], clip_gradient=c["clip_gradient"],
            mu_dtype=torch.bfloat16 if c["bf16_momentum"] else torch.float32, **common,
        )
