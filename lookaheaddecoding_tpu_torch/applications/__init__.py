"""The applications on the port, each run as
``python -m lookaheaddecoding_tpu_torch.applications.<name>``: ``minimal``,
``chatbot``, the evaluation harness (``eval_common`` and the ``eval_*``
frontends), ``train_synthetic`` and ``bench_learned``; ``synthetic`` builds
the transition-cycle model they and ``chip_smoke.py`` run."""
