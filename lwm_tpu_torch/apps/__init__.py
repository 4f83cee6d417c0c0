"""Command-line apps of the port (`python -m lwm_tpu_torch.apps.<name>`)."""
