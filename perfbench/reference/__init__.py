"""The plain reference that decides ``correct``.

Plain PyTorch and numpy, written from the published definitions and from no
code of the program: it imports nothing of ``tvidz_tpu_torch`` (nor of the
JAX package) and takes no table the program made. ``video`` hashes frames
and finds scene cuts; ``search`` finds each query frame's nearest catalog
row, counts fingerprint evidence, matches cut timestamps and aligns
fragments; ``replay`` applies the analyzer's verdict rule to those answers.
Everything runs in blocks, so a 2^24-row catalog fits beside the rest.
"""
