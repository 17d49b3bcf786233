from repro_torch.core.lora.manager import AdapterSpec, LoRAController  # noqa: F401
