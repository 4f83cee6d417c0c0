"""lwm_tpu_torch: the PyTorch + CUDA port of lwm_tpu for NVIDIA Hopper.

The JAX package `lwm_tpu` is the reference this package is held against;
nothing here imports it (only the tests import both). This slice is the
single-device in-flight serving path:

    serve.InflightServer → models.llama.LLaMAForCausalLM
        → ops.flash.flash_attention_fwd   (admission prefill, CUDA kernel)
        → ops.decode.flash_decode         (every decode round, CUDA kernel)

Kernels are built from `csrc/*.cu` with nvcc at first use (ops/_build.py);
importing any module here builds nothing and needs no GPU.
"""
