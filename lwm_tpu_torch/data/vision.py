"""Vision-text data pipeline of the trainer (`lwm_tpu/data/vision.py`), in
numpy: JSONL lines of pre-tokenized VQ codes and text → a (batch, seq)
batch with next-token targets, loss masks and vision masks.

- `VisionTextProcessor` (`:28-132`): `fields_from_example` names the
  example's field spec, a comma-separated string or a list of them (one
  picked by `fields_index`, or by `random.Random(line index)`, so a line's
  pick does not depend on the tokenizer pool's scheduling). `[field]`
  gives loss mask 0; `<|bos|>` and `<|eos|>` insert those tokens; a field
  whose name holds "vision" is a clip of `n_tokens_per_frame`-code frames
  (subsampled to `max_n_frames` by `np.linspace`), wrapped in the text
  tokens of `<vision>` and `</vision>`, each frame closed by EOF (8192)
  and the last by EOV (8193); other fields are text, `a+b` joined by
  `subfield_separator`, `prepend_text` before field 0. Vision masks mark
  the codes and their EOF/EOV. Text goes through `Tokenizer.encode` with
  its default `add_special_tokens=True`, as the JAX processor calls HF's
  tokenizer: with the LLaMA post-processor each text field and both
  wrappers start with a BOS.
- `JsonVisionDataset` (`:135-377`): the text dataset's line reader,
  tokenizer pool, resume state and `dataset_*` metrics
  (`data.text.JsonDataset`), packing by `mode`: "pad", one example a row
  cut to seq + 1 tokens and padded with BOS (loss and vision masks 0);
  "no_pad", the packed stream. Batches carry `input_vision_masks` and
  `target_vision_masks` (bool). As in the JAX dataset,
  `always_start_with_bos` is not read, and the packing runs in Python
  lists (the native buffer has no vision stream). On a mesh each rank
  keeps its part of the global batch, vision masks included, through
  `data.text.shard_batch`, as the JAX dataset's batches go through
  `shard_batch_to_global` (`lwm_tpu/data/vision.py:256-262`).

Resume: the state names the line after the last one read, as the port's
text dataset's does, so a resumed run continues the uninterrupted run's
example indices (and with them each line's random field pick); the JAX
dataset saves the last line's index and resumes one low (ROADMAP C4), and
the port resumes from a JAX state as the JAX dataset does.
"""

from __future__ import annotations

import random

import numpy as np

from lwm_tpu_torch.data.text import (
    JSON_VISION_DATASET_DEFAULTS, VISION_TEXT_PROCESSOR_DEFAULTS, JsonDataset,
)
from lwm_tpu_torch.utils.flags import merge_config


class VisionTextProcessor:
    """The vision field DSL: example → (tokens, loss_masks, vision_masks,
    keep[, aux...]); see the module note."""

    @staticmethod
    def get_default_config(updates=None):
        return merge_config(VISION_TEXT_PROCESSOR_DEFAULTS, updates, "vision_text_processor")

    def __init__(self, config, tokenizer):
        self.config = self.get_default_config(config)
        if not self.config["fields_from_example"]:
            raise ValueError("vision_text_processor.fields_from_example is required")
        self.tokenizer = tokenizer
        self.vision_start = tokenizer.encode("<vision>")
        self.vision_end = tokenizer.encode("</vision>")

    def _frames(self, codes):
        """The clip's frames of `n_tokens_per_frame` codes, subsampled to
        `max_n_frames` evenly spaced ones when it has more."""
        n = self.config["n_tokens_per_frame"]
        frames = [codes[j * n:(j + 1) * n] for j in range(len(codes) // n)]
        if 0 < self.config["max_n_frames"] < len(frames):
            picks = np.linspace(0, len(frames) - 1, self.config["max_n_frames"]).astype(int)
            frames = [frames[j] for j in picks]
        if not frames:
            raise ValueError(f"a vision field of {len(codes)} codes holds no whole frame")
        return frames

    def __call__(self, example, has_aux=False, add_bos_token=True, add_eos_token=True):
        c = self.config
        if has_aux:
            example, *aux = example
        else:
            aux = ()
        tokens, masks, vision = [], [], []

        def add(ids, mask, is_vision):
            tokens.extend(ids)
            masks.extend([mask] * len(ids))
            vision.extend([is_vision] * len(ids))

        fields = example[c["fields_from_example"]]
        if isinstance(fields, (tuple, list)):
            if c["fields_index"] >= 0:
                fields = fields[c["fields_index"]]
            else:
                fields = random.Random(aux[-1] if aux else 0).choice(fields)
        if add_bos_token and c["add_bos_token"]:
            add([self.tokenizer.bos_token_id], 0.0, False)
        for i, field in enumerate(fields.split(",")):
            if field.startswith("[") and field.endswith("]"):
                field, mask = field[1:-1], 0.0
            else:
                mask = 1.0
            if field == "<|bos|>":
                add([self.tokenizer.bos_token_id], mask, False)
            elif field == "<|eos|>":
                add([self.tokenizer.eos_token_id], mask, False)
            elif "vision" in field:
                frames = self._frames(list(example[field]))
                add(self.vision_start, mask, False)
                for j, frame in enumerate(frames):
                    end = c["eov_token"] if j == len(frames) - 1 else c["eof_token"]
                    add([*frame, end], mask, True)
                add(self.vision_end, mask, False)
            else:
                text = c["subfield_separator"].join(example[sub] for sub in field.split("+"))
                if i == 0:
                    text = c["prepend_text"] + text
                add(self.tokenizer.encode(text), mask, False)
        if add_eos_token and c["add_eos_token"]:
            add([self.tokenizer.eos_token_id], 1.0, False)
        return (tokens, masks, vision, True, *aux)


class JsonVisionDataset(JsonDataset):
    """JSONL vision-text lines packed into training batches by `mode`; see
    the module note. `node_info`: {"dp_node_size", "dp_node_rank"}."""

    @staticmethod
    def get_default_config(updates=None):
        return merge_config(JSON_VISION_DATASET_DEFAULTS, updates, "json_vision_dataset")

    def __iter__(self):
        if self.config["mode"] == "pad":
            return self._iter_pad()
        if self.config["mode"] == "no_pad":
            return self._iter_no_pad()
        raise ValueError(f"unknown mode: {self.config['mode']}")

    def _local_batch_size(self):
        return self.config["batch_size"] // self._dp()[0]

    def _iter_pad(self):
        """One example a row: cut to seq + 1 tokens, padded with BOS."""
        seq, rows = self.config["seq_length"], self._local_batch_size()
        chunk_size = self.config["batch_size"] * seq
        bos = self._tokenizer.bos_token_id
        metrics = self._metrics_fn(chunk_size)
        buffer = []
        for tokens, loss_masks, vision_masks, _keep, loc, index in self._examples():
            buffer.append((tokens[:seq + 1], loss_masks[:seq + 1], vision_masks[:seq + 1]))
            while len(buffer) >= rows:
                self._total_tokens += chunk_size
                batch = {
                    "input_tokens": np.full((rows, seq), bos, np.int32),
                    "target_tokens": np.full((rows, seq), bos, np.int32),
                    "loss_masks": np.zeros((rows, seq), np.float32),
                    "input_vision_masks": np.zeros((rows, seq), bool),
                    "target_vision_masks": np.zeros((rows, seq), bool),
                }
                for i, (toks, lm, vm) in enumerate(buffer[:rows]):
                    n = max(len(toks) - 1, 0)
                    batch["input_tokens"][i, :n] = toks[:-1]
                    batch["target_tokens"][i, :n] = toks[1:]
                    batch["input_vision_masks"][i, :n] = vm[:-1]
                    batch["target_vision_masks"][i, :n] = vm[1:]
                    batch["loss_masks"][i, :n] = lm[1:]
                yield batch, metrics(loc, index)
                buffer = buffer[rows:]

    def _iter_no_pad(self):
        """The packed stream, as the text dataset packs it, with vision masks."""
        seq, rows = self.config["seq_length"], self._local_batch_size()
        chunk = rows * seq
        global_chunk = self.config["batch_size"] * seq
        metrics = self._metrics_fn(global_chunk)
        tokens_buf, masks_buf, vision_buf = [], [], []
        for tokens, loss_masks, vision_masks, _keep, loc, index in self._examples():
            tokens_buf.extend(tokens)
            masks_buf.extend(loss_masks)
            vision_buf.extend(vision_masks)
            while len(tokens_buf) > chunk + 1:
                self._total_tokens += global_chunk
                batch = {
                    "input_tokens": np.asarray(tokens_buf[:chunk], np.int32),
                    "target_tokens": np.asarray(tokens_buf[1:chunk + 1], np.int32),
                    "loss_masks": np.asarray(masks_buf[1:chunk + 1], np.float32),
                    "input_vision_masks": np.asarray(vision_buf[:chunk], bool),
                    "target_vision_masks": np.asarray(vision_buf[1:chunk + 1], bool),
                }
                yield {k: v.reshape(rows, -1) for k, v in batch.items()}, metrics(loc, index)
                tokens_buf = tokens_buf[chunk:]
                masks_buf = masks_buf[chunk:]
                vision_buf = vision_buf[chunk:]
