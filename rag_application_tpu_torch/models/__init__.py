"""Models of the port: the LLaMA-family decoder (`decoder.py`) with
prompt-lookup speculation (`speculative.py`) and grammar constraints
(`constrain.py`), the WordPiece tokenizer (`wordpiece.py`), the text
encoder stack (`encoder.py`, `embedder.py`, `tokenizer.py`, `cache.py`)
and the BERT-family encoder with HF import (`bert.py`)."""
