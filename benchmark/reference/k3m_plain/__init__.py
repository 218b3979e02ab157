"""A frozen plain-PyTorch copy of the K3M model that the benchmark holds
the program against: the port's model code as it stood when the benchmark
was written, with every hand-written kernel replaced by its plain version
(attention.py, coattn.py, layernorm.py) and nothing imported from the
program. It runs on the CPU or the card alike, in the dtype its config
states (the benchmark runs it in float32 with TF32 off)."""
