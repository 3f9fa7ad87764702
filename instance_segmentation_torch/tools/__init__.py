"""Command-line tools of the port (``python3 -m instance_segmentation_torch.tools.<name>``)."""
