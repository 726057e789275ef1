"""The port's command-line tools, each run with ``python -m
simvg_tpu_torch.tools.<name>`` and callable in-process as ``main(argv)``:
the train and test CLIs, the serving entry points and the config-facing
tools of the JAX package's ``tools/misc``."""
