from repro_torch.data.synthetic import (
    SyntheticLM,
    batches,
    eval_batches,
    process_local_batches,
    sharded_batches,
)

__all__ = ["SyntheticLM", "batches", "eval_batches", "process_local_batches", "sharded_batches"]
