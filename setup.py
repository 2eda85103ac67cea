"""Packaging for h2o-tpu (the TPU-native H2O-3 capability rebuild)."""

from setuptools import Extension, find_packages, setup

setup(
    name="h2o-tpu",
    version="0.3.0",
    description="TPU-native distributed ML platform with the H2O-3 "
                "capability surface (jax/XLA compute, REST v3 API)",
    packages=find_packages(include=["h2o_tpu", "h2o_tpu.*",
                                    "h2o_tpu_torch", "h2o_tpu_torch.*"]),
    # the PyTorch/CUDA port builds its kernels from these at first use
    package_data={"h2o_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy", "optax"],
    extras_require={
        "io": ["pandas", "pyarrow"],
    },
    ext_modules=[
        # first-party C++ CSV tokenizer (native ingest hot loop);
        # built as a plain C extension-style shared object loaded via
        # ctypes (h2o_tpu/native/__init__.py)
        Extension("h2o_tpu.native._csv_tokenizer",
                  sources=["h2o_tpu/native/csv_tokenizer.cpp"],
                  extra_compile_args=["-O3", "-std=c++17"],
                  optional=True),
    ],
)
