from repro_torch.data.synthetic import SyntheticLM, batches

__all__ = ["SyntheticLM", "batches"]
