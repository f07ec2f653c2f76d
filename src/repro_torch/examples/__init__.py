"""The port's examples: ``quickstart``, ``comet_attention``, ``serve_lm``
and ``train_lm``, ports of the scripts in the repository's ``examples/``.
Each runs as ``python -m repro_torch.examples.<name>``; importing one
starts nothing."""
