from repro_torch.checkpoint.ckpt import load_checkpoint

__all__ = ["load_checkpoint"]
