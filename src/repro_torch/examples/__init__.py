"""The reference's four example programs (``examples/`` at the root of the
checkout) on the port, each run as ``python -m repro_torch.examples.<name>``
and on the card unless ``--device cpu`` is given:

* :mod:`.train_lm` — a small LM trained end to end, with auto-resume;
* :mod:`.serve_decode` — batched prefill and greedy decode;
* :mod:`.quickstart` — the Q-StaR pipeline on the paper's 5×5 NoC;
* :mod:`.qstar_ici_demo` — Q-StaR planning collective traffic on a torus.
"""
