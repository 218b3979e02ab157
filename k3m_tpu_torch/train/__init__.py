"""Inference loops (PyTorch port of k3m_tpu/train)."""
