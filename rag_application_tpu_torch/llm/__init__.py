from .router import ChatMessage, LLMResponse, LLMRouter, Provider, StubLLM

__all__ = ["LLMRouter", "Provider", "ChatMessage", "LLMResponse", "StubLLM"]
