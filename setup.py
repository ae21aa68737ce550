from setuptools import find_packages, setup

setup(
    name="kubeflow-tpu",
    version="0.1.0",
    description="TPU-native ML platform with Kubeflow's capabilities (kfx)",
    packages=find_packages(include=["kubeflow_tpu", "kubeflow_tpu.*",
                                    "kubeflow_tpu_torch",
                                    "kubeflow_tpu_torch.*"]),
    python_requires=">=3.10",
    entry_points={
        "console_scripts": [
            "kfx = kubeflow_tpu.cli:main",
        ]
    },
)
