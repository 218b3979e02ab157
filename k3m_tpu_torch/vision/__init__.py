"""Faster R-CNN (bottom-up-attention R101-C4) RoI feature extraction in
PyTorch (port of k3m_tpu/vision): the ResNet-101-C4 backbone with frozen
BatchNorm, the RPN with static-shape proposal selection, RoIPool and
RoIAlign as gathers, and NMS as a fixed-step masked suppression loop."""
