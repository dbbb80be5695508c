"""The paper's evaluation path on the port: Table 1 (accuracy and energy of
seven classifiers on five datasets), Figure 4 (topology), Figure 5
(threshold) and the adaptivity ablation; ``python -m repro_torch.paper.run``
prints them as CSV."""
