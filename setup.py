"""Packaging (reference: setup.py for the `fast3r` pip package)."""

from setuptools import find_packages, setup

setup(
    name="fast3r_tpu",
    version="0.1.0",
    description=(
        "TPU-native (JAX/XLA/Pallas) framework for Fast3R-style multiview "
        "3D reconstruction: N unposed images -> pointmaps + poses in one "
        "forward pass"
    ),
    packages=find_packages(include=["fast3r_tpu", "fast3r_tpu.*",
                                    "fast3r_torch", "fast3r_torch.*"]),
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "optax",
        "orbax-checkpoint",
        "pyyaml",
        "pillow",
        "scipy",
        "opencv-python",
        "safetensors",
        "huggingface-hub",
    ],
    extras_require={
        "serve": ["gradio", "viser"],
        "eval": ["scikit-learn"],
    },
    include_package_data=True,
    package_data={"fast3r_tpu": ["configs/*.yaml", "configs/experiment/*.yaml"],
                  "fast3r_torch": ["csrc/*.cu", "configs/*.yaml",
                                   "configs/*.txt", "configs/eval/*.yaml",
                                   "configs/experiment/*.yaml",
                                   "configs/experiment/*/*.yaml"]},
)
