"""Benchmark entry points of the port (counterparts of benches/ in the
JAX package), each run as `python -m gemini_tpu_torch.benches.<name>`
on `cuda` by default:

  vpubench  int32 / float32 multiply-add issue rate (vpu_chain kernel)
  mmbench   per-launch cost: copy_add and mont_mul launch chains
  addbench  ns per lane-add of the Jacobian add and projective padd
  coreops   Fr add and mul, G1 batched add

`probes` holds the two probe kernels' wrappers and plain versions.
"""
