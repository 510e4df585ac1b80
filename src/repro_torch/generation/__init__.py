from repro_torch.generation.simulator import SimulatedGenerator, GenOutput
from repro_torch.generation.prompts import build_prompt, REFUSAL_TEXT

__all__ = ["SimulatedGenerator", "GenOutput", "build_prompt", "REFUSAL_TEXT"]
