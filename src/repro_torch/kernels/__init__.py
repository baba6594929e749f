"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel module holds the plain version (what CPU tensors run, and what
the kernel is checked against on the card), the CUDA wrapper (checks its
inputs, launches, counts launches) and a dispatcher that routes a CUDA
tensor to the kernel and a CPU tensor to the plain version;
``mosa_vjp`` joins the MoSA training kernels in one autograd Function.  The
paged decode kernel lives in ``repro_torch.serve.paged_attention``,
mirroring the JAX package.
"""
