"""Models of the port: the LLaMA-family decoder (`decoder.py`) with
prompt-lookup speculation (`speculative.py`) and grammar constraints
(`constrain.py`), the WordPiece tokenizer (`wordpiece.py`), the text and
multimodal encoder stack (`encoder.py`, `embedder.py`, `tokenizer.py`,
`cache.py`) with its media front ends (`image.py`, `jpeg.py`,
`audio.py`), the BERT-family encoder with HF import (`bert.py`), and
training: contrastive data (`train_data.py`), the encoder and LM steps
(`train.py`) and LoRA adapters (`lora.py`)."""

from .encoder import MultimodalEncoder

__all__ = ["MultimodalEncoder"]
