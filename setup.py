from setuptools import find_packages, setup

setup(
    name="femo_alpha_tpu",
    version="0.1.0",
    description=(
        "TPU-native differentiable FEM + adjoint-optimization framework "
        "(capability parity with LSDOlab/femo_alpha)"
    ),
    packages=find_packages(include=["femo_alpha_tpu", "femo_alpha_tpu.*",
                                    "femo_alpha_tpu_torch",
                                    "femo_alpha_tpu_torch.*"]),
    package_data={"femo_alpha_tpu.native": ["meshops.cpp"],
                  "femo_alpha_tpu_torch": ["bench_baseline.json"],
                  "femo_alpha_tpu_torch.assembly": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy"],
    # femo_alpha_tpu_torch (the PyTorch/CUDA port) needs torch instead of jax
    extras_require={"torch": ["torch"]},
)
