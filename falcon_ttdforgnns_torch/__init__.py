"""falcon_ttdforgnns_torch — the PyTorch/CUDA port of falcon_ttdforgnns_tpu.

TT-compressed node embeddings and neighbor-sampled GraphSAGE training on
an NVIDIA Hopper GPU.  The TT lookup, its backward and the fused Adam
update of the cores are CUDA kernels written for sm_90a
(``csrc/tt_kernels.cu``); each has a plain PyTorch version that runs for
CPU tensors and that the kernel is checked against on the card.  The
package imports torch and numpy, never jax or falcon_ttdforgnns_tpu.
"""

__version__ = "0.1.0"
