"""slam_llm_tpu_torch: the PyTorch / CUDA port of slam_llm_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout and names (``models/llm.py`` is the
counterpart of ``slam_llm_tpu/models/llm.py``, and so on) and imports no JAX.
Host-side modules without JAX (config, datasets, loader, tokenizer, audio
frontend, WER) are reused from ``slam_llm_tpu`` by import.

Every kernel the JAX package wrote in Pallas for the TPU, on the ported
path, is a hand-written CUDA kernel for ``sm_90a`` under ``csrc/``, built
with ``nvcc`` at first use (``kernels/build.py``) and bound with ``ctypes``.
Each kernel's wrapper sits beside a plain PyTorch twin: CPU tensors go to
the twin, CUDA tensors to the kernel, and what the kernel cannot take raises.

Ported so far: the ASR batch-decode path (Whisper encoder, linear projector,
LoRA LLM with an int8 base, greedy and beam decode) and its LoRA training
step (frozen encoder, trained projector and LoRA, the int8_rot backward,
fused chunked cross-entropy, AdamW, ``pipeline/finetune.py``).
"""
