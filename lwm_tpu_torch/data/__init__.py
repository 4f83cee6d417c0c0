"""The trainer's data pipeline (`lwm_tpu/data`): text and vision-text."""

from lwm_tpu_torch.data.text import DatasetFactory, JsonDataset, TextProcessor
from lwm_tpu_torch.data.vision import JsonVisionDataset, VisionTextProcessor

__all__ = ["DatasetFactory", "JsonDataset", "JsonVisionDataset", "TextProcessor",
           "VisionTextProcessor"]
