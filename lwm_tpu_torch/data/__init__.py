"""The trainer's data pipeline (`lwm_tpu/data`), text only."""

from lwm_tpu_torch.data.text import DatasetFactory, JsonDataset, TextProcessor

__all__ = ["DatasetFactory", "JsonDataset", "TextProcessor"]
