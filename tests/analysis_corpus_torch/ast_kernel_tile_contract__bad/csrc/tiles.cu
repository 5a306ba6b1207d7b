// LAF304 bad twin: the kernel's tiles
constexpr int kRows = 128;   // query rows per block
#define WORDS_PER_TILE 4
