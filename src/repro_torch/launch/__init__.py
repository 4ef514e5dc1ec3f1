"""Launchers and the multi-device programs: the training CLI
(``train.py``), the serving CLI (``serve.py``), the tuning knobs
(``tuning.py``), device meshes over ``torch.distributed`` (``mesh.py``),
meta-device input specs (``specs.py``), and the two programs installed
into the models through ``models.shardctx``: flash-decoding over a
sequence-split KV cache (``flash_decode.py``) and expert-parallel MoE
(``moe_ep.py``). Importing the package imports none of them."""
