"""Models of the port: the LLaMA-family decoder (`decoder.py`) and the
WordPiece tokenizer (`wordpiece.py`)."""
