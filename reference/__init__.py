"""Plain PyTorch references of methods the port runs, outside both packages."""
