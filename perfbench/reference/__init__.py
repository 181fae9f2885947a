"""Plain PyTorch reference of the benchmark's two paths.

It follows the published description of RL-GAN-Net's networks
(Sarmad et al., CVPR 2019; the PointNet autoencoder of Achlioptas et al.)
and of the attention-encoder / adaptive-decoder variant, in float32 with
TF32 off, from a parameter tree in the JAX package's layout: dense
weights (in, out) under ``w`` / ``b``, BatchNorm ``scale`` / ``bias`` with
running ``mean`` / ``var``, spectral-norm vectors ``u`` / ``v``.

It imports torch alone: no kernel, no module of the program under test.
Everything the program derives from the benchmark's inputs (folded
engines, packed weights, BatchNorm statistics, the training draws'
effects) it works out again from those inputs.
"""

import torch


def set_tf32(enabled: bool) -> None:
    """TF32 for float32 matrix products and convolutions: off for the
    reference, on for its control (the nearest precision below float32
    with TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
