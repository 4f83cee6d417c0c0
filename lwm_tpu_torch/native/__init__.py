"""Host-side native code of the port (not CUDA): the data pipeline's
token-packing buffer."""
