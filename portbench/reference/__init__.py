"""The plain float32 reference the benchmark holds the program to.

Plain PyTorch and NumPy, written from the published descriptions: the
Kaldi log-mel front end of `ASTFeatureExtractor`, the AST forward of
`ASTForAudioClassification`, the two-stage gate and summary of the study's
`test_long_audio_windows_2stage` scripts, cross-entropy and the HF
Trainer's AdamW. It imports nothing of the program and nothing of JAX.
Every product runs in true float32: TF32 is switched off while it runs.
"""
