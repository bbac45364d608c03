from repro_torch.checkpoint.ckpt import restore, save

__all__ = ["restore", "save"]
