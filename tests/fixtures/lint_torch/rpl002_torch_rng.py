"""RPL002 fixture: torch's global generator vs explicit generators."""
import torch


def bad_global(n):
    a = torch.randn(n)                      # finding: global generator
    b = torch.randint(0, 10, (n,))          # finding: global generator
    c = torch.rand_like(a)                  # finding: takes no generator
    torch.manual_seed(0)                    # finding: global seeding
    torch.cuda.manual_seed_all(0)           # finding: global seeding
    w = torch.empty(n).normal_()            # finding: in-place, global
    return a, b, c, w


def good_seeded(n, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(n, generator=g)
    p = torch.randperm(n, generator=g)
    w = torch.empty(n).uniform_(-1.0, 1.0, generator=g)
    return a, p, w
