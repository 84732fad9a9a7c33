"""The benchmark's frozen plain reference of the port's timed paths.

Plain ``torch`` operations in float32 on NHWC tensors, written from the
published model (iPOKE, Blattmann et al., ICCV 2021) as the port implements
it, and frozen here so that a later change to the port cannot move the
yardstick.  Nothing in this package imports JAX, the JAX package or the
port: each cell hands the same weights and inputs to the port and to this
reference, and the reference works out everything else again.

``sample``: ``forward_sample`` (conditioning towers, the multiscale MaCow
flow's inverse with every masked-conv-flow inverse as a row loop, the
ConvGRU + SPADE decode).  ``gan``: one stage-1 cVAE-GAN train step (the
temporal and spatial discriminator updates with the gradient penalty's
double backward, the generator update with VGG19's perceptual loss, three
Adam updates).
"""
