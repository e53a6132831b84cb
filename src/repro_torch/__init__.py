"""PyTorch port of the Fed2 reproduction (``src/repro``), for one NVIDIA
H100.

The package mirrors ``repro``'s layout module for module and imports
torch, numpy, scipy (FedMA's Hungarian matching, ``core/matching.py``)
and the standard library only: never jax, never ``repro``. Entry points
(``fl.runtime.run_federated``, ``fl.scenarios.run_scenario``,
``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.scenarios``, ``python -m
repro_torch.launch.auto_depth``, ``python -m repro_torch.launch.serve``)
run on the CUDA card unless the caller asks for the CPU. The kernels of
these paths are written by hand for Hopper: ``kernels/paired_fusion.py``
(CUDA C++, ``csrc/paired_fusion.cu``) and ``kernels/local_step.py``
(Triton) in the synchronous round, ``kernels/feature_stats.py`` (CUDA
C++, ``csrc/feature_stats.cu``) in Eq. 9's class preference vectors,
where one launch reduces every (tapped layer, class) pair, and
``kernels/ssd_update.py`` and ``kernels/grouped_matmul.py`` (CUDA C++,
``csrc/ssd_update.cu``, ``csrc/grouped_matmul.cu``) in Mamba-2 serving:
the SSM recurrence of every decode step and the Fed2 block-diagonal
unembedding.
"""
