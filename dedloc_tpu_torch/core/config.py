"""The port's copy of the local-step recipe that `roles/common.py` reads.

Copy of ``TrainingArguments`` from ``dedloc_tpu/core/config.py`` (same
fields, names and defaults, so a later slice can parse the same
``--training.*`` flags). The rest of the collaboration config tree comes
with the slices that use it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class TrainingArguments:
    """Local-step recipe, mirroring AlbertTrainingArguments
    (albert/arguments.py:104-128)."""

    model_size: str = "large"  # tiny (CI fixture) | large
    # nothing|dots|dots_no_batch|dots_no_batch_attn|fused_ln|fused_ln_gelu;
    # the fused_ln* names turn the fused add+LN kernel on
    remat_policy: str = ""
    attention_impl: str = ""  # override: dense|blockwise|flash|ring
    vocab_size: int = 0  # override model vocab (0 = size default)
    dataset_path: str = ""  # tokenized dataset dir; empty = synthetic fixture
    streaming_files: List[str] = field(default_factory=list)
    streaming_weights: List[float] = field(default_factory=list)
    streaming_buffer_size: int = 10_000
    tokenizer_path: str = ""
    max_local_steps: int = 0  # stop after N accumulation boundaries (0 = forever)
    seq_length: int = 512
    per_device_batch_size: int = 4
    mesh_devices: int = 1
    mesh_device_offset: int = 0
    mesh_seq_devices: int = 1
    mesh_model_devices: int = 1
    mesh_pipe_devices: int = 1
    pipe_microbatches: int = 0
    mesh_expert_devices: int = 1
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    zero_sharding: bool = False
    gradient_accumulation_steps: int = 2
    learning_rate: float = 0.00176
    warmup_steps: int = 5000
    total_steps: int = 125_000
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    clamp_value: float = 10000.0
    seed: int = 0
    output_dir: str = "outputs"
    save_steps: int = 500
    save_total_limit: int = 2
    train_log_path: str = ""  # per-global-step JSONL: wall/step/loss/phases
    log_perf_steps: int = 0  # log a phase report every N global steps
