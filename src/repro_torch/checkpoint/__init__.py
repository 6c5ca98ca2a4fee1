from repro_torch.checkpoint.store import load_pytree, save_pytree

__all__ = ["save_pytree", "load_pytree"]
