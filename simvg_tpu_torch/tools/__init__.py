"""The port's command-line tools: ``train``, ``test`` and
``make_synth_data`` (run with ``python -m simvg_tpu_torch.tools.<name>``)."""
