"""The reference's examples as modules of the port: ``python -m
repro_torch.examples.<name>`` (quickstart, fed2_cifar_fl,
llm_federated_finetune, serve_decode). Each runs on the CUDA card
unless ``--device cpu`` is given. The fifth, ``auto_depth_fed2.py``, is
``repro_torch.launch.auto_depth``."""
