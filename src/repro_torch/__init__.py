"""PyTorch port of the Fed2 reproduction (``src/repro``), for one NVIDIA
H100.

The package mirrors ``repro``'s layout module for module and imports
torch, numpy and the standard library only: never jax, never ``repro``.
Entry points (``fl.runtime.run_federated``, ``fl.scenarios.run_scenario``,
``python -m repro_torch.launch.train``) run on the CUDA card unless the
caller asks for the CPU. The two kernels of the synchronous round's path
are written by hand for Hopper: ``kernels/paired_fusion.py`` (CUDA C++,
``csrc/paired_fusion.cu``) and ``kernels/local_step.py`` (Triton).
"""
