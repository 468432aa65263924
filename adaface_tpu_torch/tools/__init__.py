"""The port's command-line tools: `python -m adaface_tpu_torch.tools.<name>`."""
