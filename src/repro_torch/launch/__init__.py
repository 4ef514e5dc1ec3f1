"""Launchers: the training CLI (``train.py``). The rest of the reference's
``repro.launch`` (mesh, specs, tuning, serve, flash_decode, moe_ep) is the
multi-device slice's."""
