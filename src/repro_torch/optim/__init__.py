from repro_torch.optim.optimizers import adamw, apply_updates, sgd

__all__ = ["sgd", "adamw", "apply_updates"]
