"""Metrics log of the trainer (`lwm_tpu/utils/logging.py:20-105`).

`MetricsLogger` names the run `<experiment_id>` (a fresh uuid when none is
given, else the id with `--<8 hex>` appended unless `append_uuid` is off)
and writes under `<output_dir>/<experiment_id>/`: `variant.json` (the
flags) and `metrics.jsonl`, one record a `log` call with the JAX logger's
keys: `_time` (seconds since the epoch), `_step` when a step is passed, and
the metrics as plain numbers (0-dim tensors and numpy scalars are read with
`.item()`, which waits for the device). With `online` and an importable
`wandb`, metrics go to W&B instead, as in the JAX logger.
"""

from __future__ import annotations

import json
import os
import time
import uuid

from lwm_tpu_torch.utils.flags import flatten_config_dict, merge_config, placeholder

DEFAULTS = dict(
    online=False, prefix="lwm_tpu", project_id="", experiment_id=placeholder(str),
    append_uuid=True, experiment_note=placeholder(str), output_dir="/tmp/lwm_tpu",
    wandb_dir="", profile_dir="",
)


def _to_jsonable(v):
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _to_jsonable(x) for k, x in v.items()}
    return v


class MetricsLogger:
    @staticmethod
    def get_default_config(updates=None):
        return merge_config(DEFAULTS, updates, "logger")

    def __init__(self, config, variant, enable=True):
        self.config = self.get_default_config(config)
        self.enable = enable
        self.variant = variant
        c = self.config
        if not c["experiment_id"]:
            c["experiment_id"] = uuid.uuid4().hex
        elif c["append_uuid"]:
            c["experiment_id"] = f"{c['experiment_id']}--{uuid.uuid4().hex[:8]}"
        self._output_dir = os.path.join(c["output_dir"], c["experiment_id"])
        self._wandb_run = None
        self._jsonl = None
        if not enable:
            return
        os.makedirs(self._output_dir, exist_ok=True)
        if c["online"]:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                self._wandb_run = wandb.init(
                    project=c["project_id"] or None, id=c["experiment_id"],
                    notes=c["experiment_note"],
                    config=flatten_config_dict(variant) if variant else None,
                    dir=c["wandb_dir"] or None, resume="allow",
                )
        if self._wandb_run is None:
            self._jsonl = open(os.path.join(self._output_dir, "metrics.jsonl"), "a")
            with open(os.path.join(self._output_dir, "variant.json"), "w") as f:
                json.dump(_to_jsonable(variant), f, indent=2, default=str)

    def log(self, metrics, step=None):
        if not self.enable:
            return
        if self._wandb_run is not None:
            self._wandb_run.log(metrics, step=step)
            return
        record = {"_time": time.time()}
        if step is not None:
            record["_step"] = step
        record.update({k: _to_jsonable(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(record, default=str) + "\n")
        self._jsonl.flush()

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

    @property
    def output_dir(self):
        return self._output_dir
