"""Command-line drivers of the port, mirroring the JAX package's
(`vit3d_ensemble_tpu/cli/`) and the reference's scripts (`README.md:48-83`):
the same names, flags and defaults, run as
`python -m vit3d_ensemble_tpu_torch.cli.<driver>`.  They run on the CUDA
device unless `--device` names another."""
