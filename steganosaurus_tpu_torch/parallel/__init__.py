"""Parallel layer (the port's twin of steganosaurus_tpu/parallel): the batch
device cores, the batch axis over a Mesh of devices (make_mesh,
shard_batch; the pipeline's mesh= argument), and one image's spectrum
sharded across a mesh axis (fft_dist). One process drives every device."""

from steganosaurus_tpu_torch.parallel.batch import (  # noqa: F401
    batched_embed_core,
    batched_read_core,
    make_mesh,
    shard_batch,
)
from steganosaurus_tpu_torch.parallel.fft_dist import (  # noqa: F401
    fft2_distributed,
    ifft2_real_distributed,
)
