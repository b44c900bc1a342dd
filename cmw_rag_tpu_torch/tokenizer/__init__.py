from cmw_rag_tpu_torch.tokenizer.bpe import BPETokenizer, get_tokenizer

__all__ = ["BPETokenizer", "get_tokenizer"]
