"""K3M model modules (PyTorch port of k3m_tpu/model)."""
