"""Weights in and out of the port: the npz + msgpack checkpoint format
of the JAX package (``io``), and conversion from and to the JAX
package's numpy-leaved params, the paper LSTM's and the model zoo's
(``convert``)."""

from repro_torch.checkpoint.io import (CheckpointCorruptError, assemble,
                                       dump_checkpoint_bytes, load_checkpoint,
                                       load_checkpoint_bytes, save_checkpoint)

__all__ = ["CheckpointCorruptError", "assemble", "dump_checkpoint_bytes",
           "load_checkpoint", "load_checkpoint_bytes", "save_checkpoint"]
