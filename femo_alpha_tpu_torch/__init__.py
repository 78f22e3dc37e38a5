"""femo_alpha_tpu_torch — the PyTorch/CUDA port of femo_alpha_tpu.

A second package beside the JAX one (which stays the reference): the same
module names, PyTorch idiom inside. It imports torch and never jax. Every
table is created with an explicit dtype (f64 by default) and every
operation runs on the device of the tensors it is given; the two Hopper
kernels of the solve path (assembly/cuda_kernels.py) are built by nvcc at
first use and launched for CUDA tensors, while CPU tensors take their
plain PyTorch twins.

Ported so far: the RM-shell statics of element-wise isotropic material
(`models.RMShellModel(...).evaluate` and the backward of any output) on
structured plates with strong BCs (geometric MG) and on gmsh or generated
wings with penalty BCs (band Cholesky), with the stress outputs; the
transient shell (`models.dynamic_rm_shell.PlateSim`); modal analysis
(`RMShellModel.evaluate_modal` / `modal_eigenvalues`, LOBPCG or a dense
eigh, `solvers.eigen`) and the handbook buckling margins; the SLSQP
design-optimization loop (`opt.OptimizationProblem`), the csdl
operation contracts (`csdl_opt`) and npz checkpoints (`io`); the generic
FEA library (`models.PoissonModel`, `NonlinearPoissonModel`,
`ElasticityModel`, `EulerBernoulliBeamModel`; Jacobi-CG, GMRES, Newton,
dense Cholesky / LU solves in `solvers`) and the XDMF/VTU I/O (`io`). See
ROADMAP.md for what remains.
"""

__version__ = "0.1.0"
