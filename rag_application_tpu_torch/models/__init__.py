"""Models of the port: the LLaMA-family decoder (`decoder.py`) with
prompt-lookup speculation (`speculative.py`) and grammar constraints
(`constrain.py`), the WordPiece tokenizer (`wordpiece.py`), the text and
multimodal encoder stack (`encoder.py`, `embedder.py`, `tokenizer.py`,
`cache.py`) with its media front ends (`image.py`, `jpeg.py`,
`audio.py`), and the BERT-family encoder with HF import (`bert.py`)."""

from .encoder import MultimodalEncoder

__all__ = ["MultimodalEncoder"]
