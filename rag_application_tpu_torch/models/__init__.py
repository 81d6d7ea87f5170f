"""Models of the port: the LLaMA-family decoder (`decoder.py`), the
WordPiece tokenizer (`wordpiece.py`), and the text encoder stack
(`encoder.py`, `embedder.py`, `tokenizer.py`, `cache.py`)."""
