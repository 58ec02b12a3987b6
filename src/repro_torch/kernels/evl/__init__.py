from repro_torch.kernels.evl.ops import evl_loss

__all__ = ["evl_loss"]
