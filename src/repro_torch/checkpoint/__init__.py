"""Elastic checkpoints in the reference's ``repro-elastic-ckpt/v2`` format
(``repro/checkpoint``), byte-compatible both ways."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    FORMAT,
    AsyncCheckpointer,
    CheckpointBarrierTimeout,
    CheckpointCorruptError,
    RestoreStats,
    Sharded,
    checkpoint_size_report,
    gc_checkpoints,
    last_restore_stats,
    latest_step,
    latest_valid_step,
    list_steps,
    merge_manifests,
    per_process_restore_bytes,
    restore_checkpoint,
    restore_latest_valid,
    restore_local_shards,
    save_checkpoint,
    simulate_processes,
    verify_checkpoint,
)
