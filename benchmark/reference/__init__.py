"""The plain reference that decides ``correct``: frozen copies of the port's
model (``efficientseg.py`` and its blocks), decode, targets and losses, run in
float32, with each of the port's CUDA kernels replaced by the frozen copy of
its plain PyTorch twin (``kernels.py``); ``train.py`` holds the reference
training step and its optimizer. Nothing here imports the port."""
