"""Plain PyTorch CLIP4Clip in fp32 (TF32 off): the reference that decides
`correct`.  It imports torch and nothing of the program."""
