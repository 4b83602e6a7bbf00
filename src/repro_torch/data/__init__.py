from repro_torch.data.pipeline import TokenStream, make_lm_batches

__all__ = ["TokenStream", "make_lm_batches"]
