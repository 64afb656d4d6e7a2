"""Package metadata for dlrover_tpu.

Console entry points mirror the reference's ``dlrover-run``
(setup.py:63-69): ``tpu-run`` is the elastic launcher, and
``tpu-run-torch`` the PyTorch port's.
"""

from setuptools import find_packages, setup

setup(
    name="dlrover-tpu",
    version="0.1.0",
    description=(
        "TPU-native elastic distributed training framework "
        "(JAX/XLA/pjit/Pallas)"
    ),
    packages=find_packages(include=["dlrover_tpu", "dlrover_tpu.*", "dlrover_tpu_torch*"]),
    python_requires=">=3.10",
    install_requires=[],  # jax/flax/optax expected in the environment
    entry_points={
        "console_scripts": [
            "tpu-run = dlrover_tpu.trainer.run:main",
            "dlrover-tpu-master = dlrover_tpu.master.main:main",
            "tpu-run-torch = dlrover_tpu_torch.trainer.run:main",
        ]
    },
)
