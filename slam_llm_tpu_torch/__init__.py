"""slam_llm_tpu_torch: the PyTorch / CUDA port of slam_llm_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout and names (``models/llm.py`` is the
counterpart of ``slam_llm_tpu/models/llm.py``, and so on) and imports
nothing of JAX or of ``slam_llm_tpu``: the host modules its entry points
reach (``config``, ``registry``,
``data/{speech_dataset,audio_dataset,loader,tokenizer}``,
``ops/{audio,specaug,fbank}``, ``utils/{logging_utils,caption_metrics,spice}``)
are its own copies, under the JAX package's module names.

Every kernel the JAX package wrote in Pallas for the TPU, on the ported
path, is a hand-written CUDA kernel for ``sm_90a`` under ``csrc/``, built
with ``nvcc`` at first use (``kernels/build.py``) and bound with ``ctypes``.
Each kernel's wrapper sits beside a plain PyTorch twin: CPU tensors go to
the twin, CUDA tensors to the kernel, and what the kernel cannot take raises.

Ported so far: the ASR batch-decode path (Whisper encoder, linear projector,
LoRA LLM with an int8 base, greedy and beam decode) and its LoRA training
step (frozen encoder, trained projector and LoRA, the int8_rot backward,
fused chunked cross-entropy, AdamW, ``pipeline/finetune.py``), and the
weights path around them: HF checkpoints in (``utils/hf_loader.py``),
trainable checkpoints out and back in (``model.pt`` or the JAX package's
``model.msgpack``, ``utils/checkpoint.py``), the Llama tokenizer
(``data/tokenizer.py``), WER (``utils/wer.py``), HF export
(``utils/hf_export.py``) and the interactive ``pipeline/inference.py``, with
their file formats read and written in plain Python
(``utils/safetensors_io.py``, ``utils/msgpack_codec.py``); the
speech-translation recipe (Q-Former, Qwen2-7B, BLEU), the WavLM / HuBERT /
emotion2vec encoders, and the audio-captioning recipes (EAT and BEATs over
a Kaldi fbank, the caption metrics).
"""
