from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint, tensor_of, unflatten

__all__ = ["load_checkpoint", "save_checkpoint", "tensor_of", "unflatten"]
