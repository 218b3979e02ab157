"""Record format, preprocessing and batch loading (PyTorch port of k3m_tpu/data)."""
