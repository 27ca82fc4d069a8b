"""The LM substrate on torch (port of ``repro.models``): dense attention
stacks whose prefill and teacher-forced forward run kernel #10."""
